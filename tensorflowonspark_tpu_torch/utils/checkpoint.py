"""Checkpoints: the JAX package's npz format, on local paths.

An own copy of the core of ``tensorflowonspark_tpu/utils/checkpoint.py``
that the training ``main_fun``s call: ``save_checkpoint`` (atomic write,
``keep`` newest), ``latest_checkpoint``, ``load_checkpoint``,
``restore_latest``, ``step_of``, ``is_chief``, ``pack_pytree`` /
``unpack_pytree``, and the read side of the blessing manifests
(``read_manifest``, ``verify_manifest``) and its write side
(``bless_checkpoint``, ``tombstone_checkpoint``, ``blessed_steps``,
``latest_blessed``), so that a tombstoned, digest-mismatched or torn
step is skipped on resume as in the JAX package, and either package
verifies the other's manifests.

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

``export_model`` is the chief-only export (``params.npz`` with the
same ``/``-joined keys, and ``export.json`` tagged
``tfos-tpu-export-v1``), which ``load_exported`` reads back; either
package loads the other's export.

The serving tier's hot reload polls :func:`latest` (a listing, never a
restore) and loads with :func:`restore_any` (newest restorable step,
``blessed_only`` honoured) or :func:`restore_step` (one step exactly).

Every path goes through ``recordio.fs``: a local path (or ``file://``)
is written to a pid-unique tmp file and renamed into place, a remote URL
(``gs://``, ``hdfs://``, ``s3://``, ``memory://``) with one PUT through
fsspec, which object stores publish atomically.

:class:`AsyncCheckpointer` keeps the JAX class's contract (``save``
returns at once; ``restore_latest``, ``restore_at``, ``wait``,
``close``, ``keep``) but writes the same npz files as
:func:`save_checkpoint`, on one background thread, where the JAX class
writes orbax step directories: importing ``orbax.checkpoint`` imports
JAX.  So both packages' restores read what the port's class writes; an
orbax step directory that the JAX class wrote is listed by
:func:`latest` and skipped by the restores.  ``restore_any(target_shardings=)``
places a restore on a device mesh (``parallel.sharding``).
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import threading
import time
import zipfile

import numpy as np

from tensorflowonspark_tpu_torch.recordio import fs as _fs
from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

EXPORT_FORMAT = "tfos-tpu-export-v1"  # the JAX package's tag


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


def _flatten_leaves(tree, prefix=""):
    """(``/``-joined key, leaf) pairs of nested dicts, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _flatten(tree):
    return {k: _to_host(v) for k, v in _flatten_leaves(tree)}


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
    return _fs.join(ckpt_dir, f"ckpt-{step:08d}.npz")


def _publish(path, write):
    """Write a file whole, so no reader sees half of it: ``write(f)``
    fills a pid-unique tmp file that is renamed into place on a local
    path (writers sharing one filesystem must not clobber each other's
    in-flight file), or a buffer written with one PUT on a remote one."""
    if _fs.is_local(path):
        lp = _fs.local_path(path)
        tmp = f"{lp}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, lp)  # atomic publish
    else:
        buf = io.BytesIO()
        write(buf)
        _fs.write_bytes(path, buf.getvalue())


def _save_flat(ckpt_dir, flat, step, keep):
    """Publish ``flat`` ({``/``-joined key: ndarray}) as checkpoint
    ``step`` and keep the ``keep`` newest: the save of both
    :func:`save_checkpoint` and :class:`AsyncCheckpointer`."""
    t0 = time.perf_counter()
    faults.check("checkpoint.save", step=step)
    _fs.makedirs(ckpt_dir)
    path = _path(ckpt_dir, step)
    _publish(path, lambda f: np.savez(f, **flat))
    logger.info("saved checkpoint %s", path)
    ckpts = sorted(p for p in _fs.listdir(ckpt_dir)
                   if p.startswith("ckpt-") and p.endswith(".npz"))
    for old in ckpts[:-keep]:
        _fs.remove(_fs.join(ckpt_dir, old))
    dt = time.perf_counter() - t0
    telemetry.record_span("checkpoint/save", dt, step=step)
    metrics_registry.inc("tfos_checkpoint_saves_total")
    metrics_registry.observe("tfos_checkpoint_save_ms", dt * 1000.0)
    return path


def save_checkpoint(ckpt_dir, params, step, keep=3):
    """Write the tree ``params`` (nested dicts of tensors or arrays) as
    ``ckpt-<step>.npz``, whole (see :func:`_publish`); keep the ``keep``
    newest.  Returns the path."""
    return _save_flat(ckpt_dir, _flatten(params), step, keep)


def load_checkpoint(path):
    """The tree of numpy arrays in one checkpoint file."""
    t0 = time.perf_counter()
    with _fs.open_file(path, "rb") as f, np.load(f) as z:
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
    return _steps_by_format(ckpt_dir)["npz"]


def export_model(export_dir, params, ctx=None, metadata=None):
    """Chief-only model export: ``params.npz`` (the tree ``params``, in
    the JAX package's layout, under ``/``-joined keys) and
    ``export.json`` (``{"format": "tfos-tpu-export-v1"}`` plus
    ``metadata``, e.g. ``predict``, the ``module:function`` that serves
    the params).  A node that is not the chief writes nothing and
    returns None; else returns ``export_dir``."""
    if ctx is not None and not is_chief(ctx):
        logger.info("export_model: not chief (%s:%s), skipping",
                    ctx.job_name, ctx.task_index)
        return None
    t0 = time.perf_counter()
    _fs.makedirs(export_dir)
    flat = _flatten(params)
    _publish(_fs.join(export_dir, "params.npz"),
             lambda f: np.savez(f, **flat))
    meta = {"format": EXPORT_FORMAT}
    meta.update(metadata or {})
    _fs.write_bytes(_fs.join(export_dir, "export.json"),
                    json.dumps(meta).encode())
    telemetry.record_span("checkpoint/export", time.perf_counter() - t0)
    logger.info("exported model to %s", export_dir)
    return export_dir


def load_exported(export_dir):
    """``(params tree of numpy arrays, metadata dict)`` of an export."""
    with _fs.open_file(_fs.join(export_dir, "params.npz"), "rb") as f, \
            np.load(f) as z:
        params = _unflatten({k: z[k] for k in z.files})
    return params, load_export_meta(export_dir)


def load_export_meta(export_dir):
    """An export's metadata alone, without its params."""
    return json.loads(_fs.read_bytes(_fs.join(export_dir, "export.json")))


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


# -- blessing manifests -------------------------------------------------------
#
# ``bless-<step>.json`` beside a checkpoint holds per-file sha256 digests
# and byte counts, the step and the eval score that gated promotion, or a
# tombstone that quarantines the step (the deploy loop's rollback), so
# that no restore path (trainer resume, serving reload, elastic adopt)
# picks it again.  The fields and their JSON form are the JAX package's.

MANIFEST_FORMAT = "tfos-bless-v1"


def manifest_path(ckpt_dir, step):
    return _fs.join(ckpt_dir, f"bless-{step:08d}.json")


def _step_files(ckpt_dir, step):
    """Relative paths of every file of checkpoint ``step``: the npz
    file, or an orbax step directory walked recursively."""
    names = []
    npz = f"ckpt-{step:08d}.npz"
    if _fs.exists(_fs.join(ckpt_dir, npz)):
        names.append(npz)
    odir = _fs.join(ckpt_dir, str(step))
    if _fs.isdir(odir):
        if _fs.is_local(odir):
            for dirpath, _dirs, files in os.walk(_fs.local_path(odir)):
                rel = os.path.relpath(dirpath, _fs.local_path(ckpt_dir))
                names.extend(os.path.join(rel, f) for f in sorted(files))
        else:
            names.extend(f"{step}/{n}" for n in sorted(_fs.listdir(odir))
                         if not n.endswith("/"))
    return names


def _write_manifest(ckpt_dir, step, manifest):
    blob = json.dumps(manifest, sort_keys=True).encode()
    path = manifest_path(ckpt_dir, step)
    _publish(path, lambda f: f.write(blob))
    return path


def bless_checkpoint(ckpt_dir, step, score=None, eval_metrics=None):
    """Write the manifest that marks ``step`` blessed: the sha256 and
    byte count of every file of the checkpoint, so a later restore can
    prove it reads the bytes that were evaluated.  Returns its path;
    raises FileNotFoundError when the step has no files."""
    files = _step_files(ckpt_dir, step)
    if not files:
        raise FileNotFoundError(
            f"bless_checkpoint: no checkpoint files for step {step} "
            f"in {ckpt_dir}")
    manifest = {
        "format": MANIFEST_FORMAT,
        "step": int(step),
        "score": None if score is None else float(score),
        "eval": dict(eval_metrics or {}),
        "files": {},
        "blessed_ts": time.time(),
        "tombstone": None,
    }
    for rel in files:
        digest, nbytes = _digest(_fs.join(ckpt_dir, rel))
        manifest["files"][rel.replace(os.sep, "/")] = {
            "sha256": digest, "bytes": nbytes}
    path = _write_manifest(ckpt_dir, step, manifest)
    telemetry.event(telemetry.DEPLOY_BLESS, step=int(step),
                    score=manifest["score"], files=len(files))
    metrics_registry.set_gauge("tfos_deploy_blessed_step", int(step))
    logger.info("blessed checkpoint step %d (%d files) -> %s",
                step, len(files), path)
    return path


def tombstone_checkpoint(ckpt_dir, step, reason):
    """Quarantine ``step``: mark its manifest (made if absent) with a
    tombstone, so every restore path skips it."""
    manifest = read_manifest(ckpt_dir, step) or {
        "format": MANIFEST_FORMAT, "step": int(step), "score": None,
        "eval": {}, "files": {}, "blessed_ts": None,
    }
    manifest["tombstone"] = {"reason": str(reason), "ts": time.time()}
    path = _write_manifest(ckpt_dir, step, manifest)
    metrics_registry.inc("tfos_deploy_tombstones_total")
    logger.warning("tombstoned checkpoint step %d: %s", step, reason)
    return path


def blessed_steps(ckpt_dir):
    """Sorted steps with a blessing manifest that is not tombstoned."""
    if not _fs.isdir(ckpt_dir):
        return []
    steps = []
    for name in _fs.listdir(ckpt_dir):
        name = name.rstrip("/")
        if not (name.startswith("bless-") and name.endswith(".json")):
            continue
        try:
            step = int(name[len("bless-"):-len(".json")])
        except ValueError:
            continue
        manifest = read_manifest(ckpt_dir, step)
        if manifest is not None and not manifest.get("tombstone"):
            steps.append(step)
    return sorted(steps)


def latest_blessed(ckpt_dir):
    """``(step, path)`` of the newest blessed checkpoint whose manifest
    verifies, or ``(None, None)``: the rollback target."""
    for step in sorted(blessed_steps(ckpt_dir), reverse=True):
        ok, reason = verify_manifest(ckpt_dir, step)
        if not ok:
            logger.warning("blessed step %d fails verify: %s", step, reason)
            continue
        npz = _path(ckpt_dir, step)
        if _fs.exists(npz):
            return step, npz
        return step, _fs.join(ckpt_dir, str(step))
    return None, None


def _digest(path):
    """(sha256-hex, byte count) of one checkpoint file, streamed."""
    h = hashlib.sha256()
    n = 0
    with _fs.open_file(path, "rb") as f:
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
    if not _fs.exists(path):
        return None
    try:
        manifest = json.loads(_fs.read_bytes(path))
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
        path = _fs.join(ckpt_dir, rel)
        if not _fs.exists(path):
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
    directory at its tail.  Local paths only (a remote read would not be
    cheap): a remote one passes, and its load is the arbiter."""
    if not _fs.is_local(path):
        return True
    try:
        with zipfile.ZipFile(_fs.local_path(path)) as z:
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
    if not _fs.exists(path):
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


# -- the serving tier's reload: listing and restore across formats ------------

def _steps_by_format(ckpt_dir):
    """``{"npz": [steps], "orbax": [steps]}`` in ``ckpt_dir``: npz files
    ``ckpt-<step>.npz`` and orbax step directories (all-digit names),
    which the JAX package's ``AsyncCheckpointer`` writes."""
    out = {"npz": [], "orbax": []}
    if not _fs.isdir(ckpt_dir):
        return out
    for name in _fs.listdir(ckpt_dir):
        if name.startswith("ckpt-") and name.endswith(".npz"):
            try:
                out["npz"].append(step_of(name))
            except ValueError:
                pass
        elif name.isdigit() and _fs.isdir(_fs.join(ckpt_dir, name)):
            out["orbax"].append(int(name))
    return {k: sorted(v) for k, v in out.items()}


NO_ORBAX = ("the port reads npz checkpoints only: orbax imports JAX, "
            "and the port's AsyncCheckpointer writes npz")


def latest_step(ckpt_dir):
    """Newest checkpoint step in ``ckpt_dir`` in either format, or None
    when the dir is absent or empty."""
    steps = _steps_by_format(ckpt_dir)
    every = steps["npz"] + steps["orbax"]
    return max(every) if every else None


def latest(ckpt_dir):
    """``(step, path)`` of the newest checkpoint in either format, or
    ``(None, None)``: the hot-reload watcher's poll, a listing that
    never restores (:func:`restore_any` does the load)."""
    steps = _steps_by_format(ckpt_dir)
    best_npz = max(steps["npz"], default=-1)
    best_orbax = max(steps["orbax"], default=-1)
    if best_npz < 0 and best_orbax < 0:
        return None, None
    if best_orbax >= best_npz:
        return best_orbax, _fs.join(ckpt_dir, str(best_orbax))
    return best_npz, _path(ckpt_dir, best_npz)


def restore_step(ckpt_dir, step):
    """The tree of checkpoint ``step`` exactly (the pinned reload).
    Raises FileNotFoundError when no checkpoint holds the step, and
    NotImplementedError when only an orbax directory does."""
    path = _path(ckpt_dir, int(step))
    if _fs.exists(path):
        return load_checkpoint(path)
    if _fs.isdir(_fs.join(ckpt_dir, str(step))):
        raise NotImplementedError(
            f"step {step} of {ckpt_dir} is an orbax checkpoint; {NO_ORBAX}")
    raise FileNotFoundError(
        f"restore_step: no checkpoint for step {step} in {ckpt_dir}")


def restore_any(ckpt_dir, target_shardings=None, blessed_only=False):
    """``(tree, step)`` from the newest restorable npz checkpoint, or
    ``(None, 0)``.  Steps that are tombstoned, fail their blessing
    manifest, are truncated or raise on load are skipped with a warning,
    and the previous step is tried; ``blessed_only=True`` also requires
    a verified blessing manifest (only promoted checkpoints serve).
    Orbax step directories are skipped with a warning.

    Without ``target_shardings`` the leaves are host numpy arrays.
    ``target_shardings`` places them on a device mesh: a tree of
    ``(mesh, placements)`` matching the restored tree, or a callable
    ``tree -> shardings`` (e.g. ``lambda t: fsdp_sharding(mesh, t)``);
    the leaves come back as DTensors holding this rank's blocks
    (``parallel.sharding.apply_shardings``).  The restore is host-side,
    so a checkpoint written under another mesh shape re-places as well,
    as the JAX package's reshard does."""
    tree, step = _restore_host(ckpt_dir, blessed_only)
    if tree is None or target_shardings is None:
        return tree, step
    from tensorflowonspark_tpu_torch.parallel import sharding

    shardings = (target_shardings(tree) if callable(target_shardings)
                 else target_shardings)
    return sharding.apply_shardings(_torch_tree(tree), shardings), step


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    import torch

    return torch.from_numpy(np.array(tree))


def _restore_host(ckpt_dir, blessed_only):
    steps = _steps_by_format(ckpt_dir)
    npz = set(steps["npz"])
    for step in sorted(npz | set(steps["orbax"]), reverse=True):
        if step not in npz:
            logger.warning("skipping checkpoint step %d: an orbax "
                           "directory; %s", step, NO_ORBAX)
            continue
        ok, reason = _restorable(ckpt_dir, step)
        if ok and blessed_only and read_manifest(ckpt_dir, step) is None:
            ok, reason = False, "unblessed"
        if not ok:
            logger.warning("skipping checkpoint step %d: %s", step, reason)
            continue
        path = _path(ckpt_dir, step)
        try:
            return load_checkpoint(path), step
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
            logger.warning("checkpoint %s unreadable: %s", path, e)
    return None, 0


# -- asynchronous saves -------------------------------------------------------

def _snapshot(tree):
    """``(flat, events)``: copies of every leaf of ``tree`` under its
    ``/``-joined key, made now, and the CUDA events that the copies of
    card tensors complete at.  A card tensor is copied into pinned host
    memory without blocking, in stream order, so the optimizer's
    in-place update that follows cannot reach the copy; a host tensor or
    array is copied at once."""
    import torch

    flat, devices = {}, set()
    for key, x in _flatten_leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x, non_blocking=True)
                devices.add(x.device)
                flat[key] = buf
            else:
                flat[key] = x.clone()
        else:
            flat[key] = np.array(x, copy=True)
    events = []
    for d in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events.append(ev)
    return flat, events


class AsyncCheckpointer:
    """Checkpoints written on a background thread, so the step loop
    blocks only for the snapshot: the JAX class's contract over the npz
    files of :func:`save_checkpoint` (see the module docstring)::

        ckpt = AsyncCheckpointer(model_dir)
        tree, start = ckpt.restore_latest()
        for step in range(start, steps):
            ...
            if step % save_every == 0:
                ckpt.save(step, tree)   # returns once the copies are queued
        ckpt.close()                    # waits for the save in flight

    ``save`` snapshots every leaf before it returns (:func:`_snapshot`),
    so the file holds the tree of its own step however the caller
    updates it in place afterwards.  One save is in flight at a time: a
    second ``save`` first waits for the one before, which bounds the
    host memory to one tree.  The writer publishes each file whole, so
    :func:`latest` and the serving tier's reload watcher never see half
    of one, and keeps the ``keep`` newest.  An exception in the writer
    (``faults.check("checkpoint.save")`` fires there too) is raised by
    the next ``save``, ``wait`` or ``close``."""

    def __init__(self, ckpt_dir, keep=3):
        if _fs.is_local(ckpt_dir):
            ckpt_dir = os.path.abspath(_fs.local_path(ckpt_dir))
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread = None
        self._error = None
        self._closed = False

    def save(self, step, tree):
        """Snapshot ``tree`` (nested dicts of tensors or arrays) and write
        it as checkpoint ``step`` in the background."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer.save after close")
        self.wait()
        flat, events = _snapshot(tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, events),
            name=f"tfos-ckpt-{step}", daemon=True)
        self._thread.start()

    def _write(self, step, flat, events):
        try:
            for ev in events:
                ev.synchronize()
            _save_flat(self.ckpt_dir, {k: _to_host(v) for k, v in
                                       flat.items()}, step, self.keep)
        except BaseException as e:  # noqa: BLE001 - raised by the owner
            self._error = e

    def wait(self):
        """Wait for the save in flight; raise what its writer raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def latest_step(self):
        return latest_step(self.ckpt_dir)

    def restore_latest(self):
        """(tree, step) of the newest restorable checkpoint, or
        (None, 0)."""
        return restore_any(self.ckpt_dir)

    def restore_at(self, step):
        """The tree of one step exactly (the pinned reload)."""
        return restore_step(self.ckpt_dir, step)

    def close(self):
        """Wait for the save in flight; later calls return at once."""
        if self._closed:
            return
        self._closed = True
        self.wait()


def async_checkpointer(ckpt_dir, keep=3):
    """The JAX package's constructor name for :class:`AsyncCheckpointer`."""
    return AsyncCheckpointer(ckpt_dir, keep=keep)
