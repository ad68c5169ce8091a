"""Checkpoints: the JAX package's npz format, on local paths.

An own copy of the core of ``tensorflowonspark_tpu/utils/checkpoint.py``
that the training ``main_fun``s call: ``save_checkpoint`` (atomic write,
``keep`` newest), ``latest_checkpoint``, ``load_checkpoint``,
``restore_latest``, ``step_of``, ``is_chief``, ``pack_pytree`` /
``unpack_pytree``, and the read side of the blessing manifests
(``read_manifest``, ``verify_manifest``), so that a tombstoned, digest-
mismatched or torn step is skipped on resume as in the JAX package.

The files are the JAX package's: ``ckpt-<step:08d>.npz`` holding one
array per leaf under its ``/``-joined path (``params/<layer>/<leaf>``,
``state/...``, ``opt/<index>``).  Either package restores the other's.
Arrays go in the JAX package's layout: a model converts its tensors
before saving (``resnet.checkpoint_tree`` writes HWIO conv kernels).

``pack_pytree`` flattens in JAX's canonical leaf order (dict keys
sorted, sequences in order), which is what ``jax.tree_util.tree_leaves``
gives.  For ``optax.sgd(lr, momentum)`` the state is
``(TraceState(trace=<params tree>), EmptyState())``, so its packed leaves
are the momentum buffers of the params in sorted-key order, and
``pack_pytree(<momentum tree>)`` here writes the same ``opt/<index>``
entries.

Local paths (and ``file://``) only; a remote URL raises
NotImplementedError.  Export, the blessing and tombstone writers, the
async checkpointer and ``restore_any`` wait in ROADMAP.md (queue 1,
item 9).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import time
import zipfile

import numpy as np

from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

CHECKPOINT_ITEM = "ROADMAP.md queue 1, item 9"
_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")


def _local(path):
    """The OS path of a local path or ``file://`` URL; raises
    NotImplementedError for any other scheme."""
    p = str(path)
    m = _SCHEME_RE.match(p)
    if m is None:
        return p
    scheme = m.group(1).lower()
    if scheme in ("file", "local"):
        return p[len(scheme) + 3:] or "/"
    raise NotImplementedError(f"checkpoints on {scheme}:// come with "
                              f"{CHECKPOINT_ITEM}")


def tree_leaves(tree):
    """Leaves of nested dicts, lists and tuples in JAX's canonical order:
    dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _to_host(x):
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = _to_host(tree)
    return out


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _path(ckpt_dir, step):
    return os.path.join(_local(ckpt_dir), f"ckpt-{step:08d}.npz")


def save_checkpoint(ckpt_dir, params, step, keep=3):
    """Write the tree ``params`` (nested dicts of tensors or arrays) as
    ``ckpt-<step>.npz`` through a pid-unique tmp file and an atomic
    rename; keep the ``keep`` newest.  Returns the path."""
    t0 = time.perf_counter()
    faults.check("checkpoint.save", step=step)
    d = _local(ckpt_dir)
    os.makedirs(d, exist_ok=True)
    flat = _flatten(params)
    path = _path(d, step)
    # pid-unique tmp: writers sharing one filesystem must not clobber each
    # other's in-flight file
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)  # atomic publish
    logger.info("saved checkpoint %s", path)
    ckpts = sorted(p for p in os.listdir(d)
                   if p.startswith("ckpt-") and p.endswith(".npz"))
    for old in ckpts[:-keep]:
        os.remove(os.path.join(d, old))
    dt = time.perf_counter() - t0
    telemetry.record_span("checkpoint/save", dt, step=step)
    metrics_registry.inc("tfos_checkpoint_saves_total")
    metrics_registry.observe("tfos_checkpoint_save_ms", dt * 1000.0)
    return path


def load_checkpoint(path):
    """The tree of numpy arrays in one checkpoint file."""
    t0 = time.perf_counter()
    with open(_local(path), "rb") as f, np.load(f) as z:
        out = _unflatten({k: z[k] for k in z.files})
    dt = time.perf_counter() - t0
    telemetry.record_span("checkpoint/restore", dt,
                          path=os.path.basename(str(path)))
    metrics_registry.inc("tfos_checkpoint_restores_total")
    metrics_registry.observe("tfos_checkpoint_restore_ms", dt * 1000.0)
    return out


def step_of(ckpt_path):
    """Step number encoded in a ``ckpt-<step>.npz`` path."""
    name = os.path.basename(str(ckpt_path))
    return int(name[len("ckpt-"):-len(".npz")])


def _npz_steps(ckpt_dir):
    d = _local(ckpt_dir)
    if not os.path.isdir(d):
        return []
    steps = []
    for name in os.listdir(d):
        if name.startswith("ckpt-") and name.endswith(".npz"):
            try:
                steps.append(step_of(name))
            except ValueError:
                pass
    return sorted(steps)


def is_chief(ctx):
    """Process 0's duties: the chief/master role, else worker 0."""
    if ctx.job_name in ("chief", "master"):
        return True
    has_chief = any(j in ctx.cluster_spec for j in ("chief", "master"))
    return not has_chief and ctx.job_name == "worker" and ctx.task_index == 0


def pack_pytree(tree):
    """A tree -> flat ``{index: ndarray}`` in JAX's canonical leaf order,
    storable by :func:`save_checkpoint` (see the module docstring)."""
    return {f"{i:05d}": _to_host(x) for i, x in enumerate(tree_leaves(tree))}


def unpack_pytree(flat, like):
    """Rebuild a tree with the structure of ``like`` (nested dicts, lists
    and tuples) from :func:`pack_pytree` output."""
    leaves = iter([flat[k] for k in sorted(flat)])

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(leaves)

    return build(like)


# -- blessing manifests: the read side ---------------------------------------
#
# ``bless-<step>.json`` beside a checkpoint holds per-file sha256 digests
# and byte counts, or a tombstone that quarantines the step.  The JAX
# package writes them (bless_checkpoint, tombstone_checkpoint); restore
# paths here honour them.

def manifest_path(ckpt_dir, step):
    return os.path.join(_local(ckpt_dir), f"bless-{step:08d}.json")


def _digest(path):
    """(sha256-hex, byte count) of one checkpoint file, streamed."""
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
            n += len(chunk)
    return h.hexdigest(), n


def read_manifest(ckpt_dir, step):
    """Parsed manifest dict for ``step``, or None (absent/unparseable)."""
    path = manifest_path(ckpt_dir, step)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            manifest = json.loads(f.read())
    except (OSError, ValueError) as e:
        logger.warning("unreadable manifest %s: %s", path, e)
        return None
    return manifest if isinstance(manifest, dict) else None


def verify_manifest(ckpt_dir, step):
    """(ok, reason) for the blessing manifest of ``step``;
    ``(False, "unblessed")`` when there is none."""
    manifest = read_manifest(ckpt_dir, step)
    if manifest is None:
        return False, "unblessed"
    if manifest.get("tombstone"):
        reason = (manifest["tombstone"] or {}).get("reason", "")
        return False, f"tombstoned ({reason})"
    files = manifest.get("files") or {}
    if not files:
        return False, "empty manifest"
    for rel, info in sorted(files.items()):
        path = os.path.join(_local(ckpt_dir), rel)
        if not os.path.exists(path):
            return False, f"missing file {rel}"
        try:
            digest, nbytes = _digest(path)
        except OSError as e:
            return False, f"unreadable file {rel}: {e}"
        if nbytes != info.get("bytes"):
            return False, (f"size mismatch {rel}: "
                           f"{nbytes} != {info.get('bytes')}")
        if digest != info.get("sha256"):
            return False, f"digest mismatch {rel}"
    return True, "ok"


def _npz_intact(path):
    """Cheap truncation check: truncation destroys a zip's central
    directory at its tail."""
    try:
        with zipfile.ZipFile(path) as z:
            z.namelist()
        return True
    except (OSError, zipfile.BadZipFile):
        return False


def _restorable(ckpt_dir, step):
    """(ok, reason): should a restore attempt ``step``?  A step with a
    manifest must verify (tombstones and digest drift are hard skips);
    one without passes; the npz must look intact."""
    if read_manifest(ckpt_dir, step) is not None:
        ok, reason = verify_manifest(ckpt_dir, step)
        if not ok:
            return False, reason
    path = _path(ckpt_dir, step)
    if not os.path.exists(path):
        return False, "missing npz"
    if not _npz_intact(path):
        return False, "truncated npz"
    return True, "ok"


def latest_checkpoint(ckpt_dir):
    """Path of the newest restorable npz checkpoint, or None; skipped
    steps are logged and the previous one wins."""
    for step in reversed(_npz_steps(ckpt_dir)):
        ok, reason = _restorable(ckpt_dir, step)
        if ok:
            return _path(ckpt_dir, step)
        logger.warning("skipping checkpoint step %d: %s", step, reason)
    return None


def restore_latest(ckpt_dir):
    """(tree, step) from the newest restorable checkpoint, or (None, 0):
    the resume half of the recovery contract.  A tombstoned, unverified,
    torn or unreadable newest step falls back to the previous one."""
    for step in reversed(_npz_steps(ckpt_dir)):
        ok, reason = _restorable(ckpt_dir, step)
        if not ok:
            logger.warning("skipping checkpoint step %d: %s", step, reason)
            continue
        path = _path(ckpt_dir, step)
        try:
            tree = load_checkpoint(path)
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
            logger.warning("checkpoint %s unreadable: %s", path, e)
            continue
        logger.info("resuming from %s", path)
        return tree, step
    return None, 0
