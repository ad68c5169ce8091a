"""PyTorch port, the blessed-checkpoint deploy loop on the CPU, held
against the JAX package (its ``tests/test_deploy.py``, test for test):

- the manifest writers (``bless_checkpoint``, ``tombstone_checkpoint``,
  ``blessed_steps``, ``latest_blessed``) and the hardened restores; a
  manifest either package writes verifies under the other's
  ``verify_manifest`` (the same fields, digests and tombstone form);
- canary routing: ``canary_arm`` equals the JAX split over 1,000 route
  ids, ``_route`` keeps an arm, an empty arm degrades to any replica;
- the elastic mirror's watermark rule equals the JAX rule case by case;
- a live 3-replica pool canaries, rolls back and promotes;
- ``PromotionController`` gates each step once;
- ``DeployLoop`` over a replica pool with no engine makes the same
  sequence of pool calls (pinned reloads, to the same replicas), the
  same verdicts and the same watermarks as the JAX loop over the JAX
  pool, in every scenario of the JAX tests (bootstrap, promote, eval,
  SLO and latency rollbacks, too little traffic, injected faults, a
  seeded chaos plan);
- the whole loop end to end on a live 3-replica pool beside an
  ``ActorSystem`` (the JAX test's slow lane, here in tier 1 at the JAX
  test's size, under a bound of :data:`BOUND_S` seconds of its own).

Numbers compare exactly (no tolerance) except the eval score, which is
float32 rounding of the same ``float()`` (``pytest.approx``'s default
1e-6 relative).  The predicts and ``eval_fn`` are module-level functions
of this file, which the executors import (plain pickle), so it imports
no JAX at the top.
"""

import contextlib
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from tensorflowonspark_tpu_torch.utils import faults  # noqa: E402

ENV = {"OMP_NUM_THREADS": "1"}
HANG = 90      # seconds: the bound of every wait
BOUND_S = 90   # seconds: the bound of each live-pool test


def _serve_version(params, inputs, device=None):
    """The JAX test's probe predict: the params' version for each row."""
    x = np.asarray(inputs["x"])
    return {"version": np.full(x.shape[0],
                               float(np.asarray(params["version"])))}


TREE = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
        "b": np.zeros(3, np.float32)}


def _save(d, step, scale=1.0, mod=ckpt):
    return mod.save_checkpoint(
        d, {"w": TREE["w"] * scale, "b": TREE["b"]}, step=step)


@contextlib.contextmanager
def _bounded(seconds=BOUND_S):
    t0 = time.monotonic()
    yield
    took = time.monotonic() - t0
    assert took < seconds, f"took {took:.1f} s, over the {seconds} s bound"


def _jax():
    from tensorflowonspark_tpu.utils import checkpoint as jckpt

    return jckpt


# -- manifest write / verify / tombstone ---------------------------------------

def test_bless_writes_verifiable_manifest(tmp_path):
    d = str(tmp_path / "ckpt")
    _save(d, 5)
    path = ckpt.bless_checkpoint(d, 5, score=0.42,
                                 eval_metrics={"loss": 0.42})
    assert os.path.basename(path) == "bless-00000005.json"
    with open(path, encoding="utf-8") as f:
        manifest = json.load(f)
    assert manifest["format"] == ckpt.MANIFEST_FORMAT
    assert manifest["step"] == 5
    assert manifest["score"] == pytest.approx(0.42)
    assert manifest["eval"] == {"loss": 0.42}
    assert manifest["tombstone"] is None
    assert manifest["files"]["ckpt-00000005.npz"]["bytes"] > 0
    ok, reason = ckpt.verify_manifest(d, 5)
    assert ok, reason
    # the JAX writer's manifest of the same file: the same fields and
    # digest, and each package verifies the other's
    jd = str(tmp_path / "jax")
    os.makedirs(jd)
    with open(os.path.join(d, "ckpt-00000005.npz"), "rb") as f, \
            open(os.path.join(jd, "ckpt-00000005.npz"), "wb") as g:
        g.write(f.read())
    jpath = _jax().bless_checkpoint(jd, 5, score=0.42,
                                    eval_metrics={"loss": 0.42})
    with open(jpath, encoding="utf-8") as f:
        jman = json.load(f)
    assert sorted(jman) == sorted(manifest)
    for key in ("format", "step", "score", "eval", "files", "tombstone"):
        assert jman[key] == manifest[key], key
    assert _jax().verify_manifest(d, 5) == (True, "ok")
    assert ckpt.verify_manifest(jd, 5) == (True, "ok")


def test_bless_missing_step_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.bless_checkpoint(str(tmp_path), 7)


def test_verify_detects_corruption_and_absence(tmp_path):
    d = str(tmp_path / "ckpt")
    path = _save(d, 3)
    assert ckpt.verify_manifest(d, 3) == (False, "unblessed")
    ckpt.bless_checkpoint(d, 3)
    # flip one byte: the digest catches silent corruption in place
    with open(path, "r+b") as f:
        f.seek(10)
        b = f.read(1)
        f.seek(10)
        f.write(bytes([b[0] ^ 0xFF]))
    ok, reason = ckpt.verify_manifest(d, 3)
    assert not ok and "digest mismatch" in reason
    assert _jax().verify_manifest(d, 3) == (ok, reason)
    os.remove(path)
    ok, reason = ckpt.verify_manifest(d, 3)
    assert not ok and "missing file" in reason
    assert _jax().verify_manifest(d, 3) == (ok, reason)


def test_tombstone_quarantines(tmp_path):
    d = str(tmp_path / "ckpt")
    _save(d, 4)
    ckpt.bless_checkpoint(d, 4)
    assert ckpt.blessed_steps(d) == [4]
    ckpt.tombstone_checkpoint(d, 4, reason="canary slo breach")
    assert ckpt.blessed_steps(d) == [] == _jax().blessed_steps(d)
    ok, reason = ckpt.verify_manifest(d, 4)
    assert not ok and "tombstoned" in reason
    assert _jax().verify_manifest(d, 4) == (ok, reason)
    # tombstoning a never-blessed step makes the quarantine marker too
    _save(d, 6)
    ckpt.tombstone_checkpoint(d, 6, reason="eval regression")
    assert not ckpt.verify_manifest(d, 6)[0]
    assert not _jax().verify_manifest(d, 6)[0]


def test_manifests_cross_verify_both_ways(tmp_path):
    """A manifest the JAX package writes (bless, tombstone) reads and
    verifies the same under the port's readers, and the other way."""
    jckpt = _jax()
    for writer, reader in ((ckpt, jckpt), (jckpt, ckpt)):
        d = str(tmp_path / writer.__name__.split(".")[0])
        for step in (1, 2, 3):
            _save(d, step, scale=float(step), mod=writer)
            writer.bless_checkpoint(d, step, score=0.5 / step,
                                    eval_metrics={"loss": 0.5 / step})
        writer.tombstone_checkpoint(d, 3, reason="rolled back")
        for step in (1, 2, 3):
            assert reader.verify_manifest(d, step) == \
                writer.verify_manifest(d, step), step
            assert reader.read_manifest(d, step) == \
                writer.read_manifest(d, step)
        assert reader.blessed_steps(d) == writer.blessed_steps(d) == [1, 2]
        assert reader.latest_blessed(d) == writer.latest_blessed(d)
        assert reader.latest_blessed(d)[0] == 2
        tree, step = reader.restore_any(d)
        assert step == 2
        np.testing.assert_array_equal(np.asarray(tree["w"]), TREE["w"] * 2)


def test_latest_blessed_picks_newest_verifying(tmp_path):
    d = str(tmp_path / "ckpt")
    assert ckpt.latest_blessed(d) == (None, None)
    _save(d, 2)
    _save(d, 8)
    ckpt.bless_checkpoint(d, 2)
    ckpt.bless_checkpoint(d, 8)
    step, path = ckpt.latest_blessed(d)
    assert step == 8 and path.endswith("ckpt-00000008.npz")
    ckpt.tombstone_checkpoint(d, 8, reason="bad")
    assert ckpt.latest_blessed(d)[0] == 2


# -- hardened restore: skip a truncated or tombstoned newest step ------------------

def test_restore_falls_back_past_truncated_newest(tmp_path):
    d = str(tmp_path / "ckpt")
    _save(d, 1, scale=1.0)
    newest = _save(d, 2, scale=2.0)
    size = os.path.getsize(newest)
    with open(newest, "r+b") as f:
        f.truncate(size // 2)
    assert ckpt.latest_checkpoint(d).endswith("ckpt-00000001.npz")
    tree, step = ckpt.restore_latest(d)
    assert step == 1
    np.testing.assert_allclose(tree["w"], TREE["w"])
    tree, step = ckpt.restore_any(d)
    assert step == 1


def test_restore_skips_tombstoned_newest(tmp_path):
    d = str(tmp_path / "ckpt")
    _save(d, 1, scale=1.0)
    _save(d, 2, scale=2.0)
    ckpt.tombstone_checkpoint(d, 2, reason="rolled back")
    assert ckpt.restore_any(d)[1] == 1
    assert ckpt.restore_latest(d)[1] == 1
    assert ckpt.latest_checkpoint(d).endswith("ckpt-00000001.npz")


def test_restore_any_blessed_only(tmp_path):
    d = str(tmp_path / "ckpt")
    _save(d, 1, scale=1.0)
    _save(d, 2, scale=2.0)
    ckpt.bless_checkpoint(d, 1)
    assert ckpt.restore_any(d, blessed_only=True)[1] == 1
    tree, step = ckpt.restore_any(d)
    assert step == 2
    np.testing.assert_allclose(tree["w"], TREE["w"] * 2)


def test_restore_step_pinned(tmp_path):
    d = str(tmp_path / "ckpt")
    _save(d, 1, scale=1.0)
    _save(d, 2, scale=2.0)
    np.testing.assert_allclose(ckpt.restore_step(d, 1)["w"], TREE["w"])
    with pytest.raises(FileNotFoundError):
        ckpt.restore_step(d, 99)


def test_digest_drift_skipped_on_restore(tmp_path):
    d = str(tmp_path / "ckpt")
    _save(d, 1, scale=1.0)
    _save(d, 2, scale=2.0)
    ckpt.bless_checkpoint(d, 2)
    _save(d, 2, scale=3.0)  # rewritten after blessing: digest drift
    assert ckpt.restore_any(d)[1] == 1


# -- fault sites ---------------------------------------------------------------

def test_deploy_fault_sites_registered():
    from tensorflowonspark_tpu.utils import faults as jfaults

    assert set(faults.DEPLOY_CHAOS_SITES) <= set(faults.SITES)
    assert faults.DEPLOY_CHAOS_SITES == jfaults.DEPLOY_CHAOS_SITES
    plan = faults.random_plan(7, sites=faults.DEPLOY_CHAOS_SITES)
    assert any(s in plan for s in faults.DEPLOY_CHAOS_SITES)
    assert plan == jfaults.random_plan(7, sites=jfaults.DEPLOY_CHAOS_SITES)


# -- canary routing (serving/replicas.py) --------------------------------------

def test_canary_arm_split_deterministic():
    from tensorflowonspark_tpu.serving import replicas as JR

    from tensorflowonspark_tpu_torch.serving import replicas as R

    ids = list(range(2000))
    arms = [R.canary_arm(i, 10) for i in ids]
    assert arms == [R.canary_arm(i, 10) for i in ids]
    assert 0.05 < sum(arms) / len(arms) < 0.15
    assert not any(R.canary_arm(i, 0) for i in ids)
    assert all(R.canary_arm(i, 100) for i in ids)
    assert R.canary_arm(42, 37) == R.canary_arm("42", 37)
    # the JAX split, exactly, over 1,000 route ids and several shares
    for pct in (1, 10, 37, 50, 99):
        rids = [f"route-{i}" for i in range(1000)]
        assert [R.canary_arm(r, pct) for r in rids] == \
            [JR.canary_arm(r, pct) for r in rids], pct


class _Recorder:
    """A replica inbox that records ``(idx, message)`` in a shared list."""

    def __init__(self, idx, log):
        self.idx, self.log = idx, log

    def put(self, msg):
        self.log.append((self.idx, msg))


class _SendLog:
    """The port pool's send queue, recording ``(idx, message)``."""

    def __init__(self, log):
        self.log = log

    def put(self, item):
        self.log.append(item)


def _bare_pool(live_idxs, pkg="port", log=None):
    """A ReplicaPool with just the routing state and no engine: the
    port's (its sends recorded) or the JAX package's (its inboxes
    recorded)."""
    if pkg == "port":
        from tensorflowonspark_tpu_torch.actors.dispatch import (
            InFlightTable,
        )
        from tensorflowonspark_tpu_torch.serving import replicas as R
    else:
        from tensorflowonspark_tpu.actors.dispatch import InFlightTable
        from tensorflowonspark_tpu.serving import replicas as R
    pool = R.ReplicaPool.__new__(R.ReplicaPool)
    pool._lock = threading.Lock()
    pool._table = InFlightTable(max(live_idxs) + 1)
    for i in live_idxs:
        pool._table.up(i, 1000 + i)
    pool._canary = None
    pool._watermark = None
    pool._reload_watermark = None
    pool._arm_stats = None
    log = [] if log is None else log
    if pkg == "port":
        pool._sendq = _SendLog(log)
    else:
        pool._inqs = {i: _Recorder(i, log) for i in live_idxs}
    pool.log = log
    return pool


def test_route_restricts_to_arm():
    pool = _bare_pool([0, 1, 2])
    pool._canary = {"replicas": (2,), "version": 9, "pct": 100.0}
    for rid in range(8):  # pct=100: every route id is canary
        entry = {}
        assert pool._route(("batch", rid), entry, rid) == 2
        assert entry["arm"] == "canary"
    pool2 = _bare_pool([0, 1, 2])
    pool2._canary = {"replicas": (2,), "version": 9, "pct": 0.0}
    owners = set()
    for rid in range(8):  # pct=0: everything stays on the baseline
        entry = {}
        owners.add(pool2._route(("batch", rid), entry, rid))
        assert entry["arm"] == "baseline"
    assert owners == {0, 1}  # least-loaded within the arm


def test_route_empty_arm_degrades_not_drops():
    pool = _bare_pool([0, 1])
    pool._canary = {"replicas": (7,), "version": 9, "pct": 100.0}
    for rid in range(4):
        assert pool._route(("batch", rid), {}, rid) in (0, 1)


def test_accept_mirror_watermark_rule():
    """The port's rule gives the JAX rule's answer in every case of the
    JAX test."""
    from tensorflowonspark_tpu.serving import elastic as JE

    from tensorflowonspark_tpu_torch.serving import elastic as E

    def accept(mod, watermark, mirror, version, reload_wm=None):
        pool = mod.ElasticReplicaPool.__new__(mod.ElasticReplicaPool)
        pool._lock = threading.Lock()
        pool._watermark = watermark
        pool._reload_watermark = reload_wm
        pool._mirror_version = mirror
        return pool._accept_mirror(version)

    cases = [((None, None, 5), True), ((None, 3, 5), True),
             ((None, 5, 3), False), ((10, None, 8), True),
             ((10, 6, 8), True), ((10, 8, 6), False),
             ((10, 8, 12), False), ((10, None, 12), True),
             ((10, 12, 14), True), ((10, 12, 8), True),
             ((None, 6, 8, 10), True), ((None, 8, 12, 10), False),
             ((None, None, 12, 10), True)]
    for args, want in cases:
        assert accept(E, *args) is want, args
        assert accept(JE, *args) is want, args


# -- staged rollout against a live pool ------------------------------------------

def _wait_versions(pool, want, timeout=HANG):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pool.versions() == want:
            return
        time.sleep(0.05)
    raise AssertionError(f"versions {pool.versions()} never became {want}")


def _version_of(client):
    return float(client.predict({"x": np.ones(1, np.float32)},
                                timeout=HANG)["version"])


def test_canary_promote_and_rollback_live_pool(tmp_path, monkeypatch):
    """The JAX test on the port's 3-replica pool: a watermark stands the
    latest-wins watcher down, a pinned canary serves the candidate to
    100% of hashed traffic, a rollback re-pins the arm at the blessed
    step, and a promotion converges the whole pool."""
    from tensorflowonspark_tpu_torch.serving import replicas as R
    from tensorflowonspark_tpu_torch.serving import server as S

    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, {"version": np.array(1.0)}, step=1)
    monkeypatch.setenv("TFOS_SERVE_RELOAD_SECS", "0.2")
    spec = R.ModelSpec(predict=_serve_version, ckpt_dir=d, device="cpu")
    with _bounded(), S.Server(spec, num_replicas=3, max_batch=8,
                              max_delay_ms=5, env=ENV,
                              request_timeout=HANG) as srv:
        pool, c = srv.pool, srv.client()
        assert set(pool.versions().values()) == {1}
        pool.set_watermark(1)
        ckpt.save_checkpoint(d, {"version": np.array(2.0)}, step=2)
        time.sleep(0.8)  # the watermark holds: the watcher stands down
        assert set(pool.versions().values()) == {1}

        assert pool.set_canary([0], version=2, pct=100) == (0,)
        _wait_versions(pool, {0: 2, 1: 1, 2: 1})
        assert [_version_of(c) for _ in range(6)] == [2.0] * 6
        stats = pool.canary_stats()
        assert stats["canary"]["n"] >= 1 and stats["canary"]["errors"] == 0
        assert stats["canary"]["p50_ms"] is not None
        assert stats["baseline"]["n"] == 0

        assert pool.rollback_canary() == 1
        assert pool.canary() is None and pool.watermark() == 1
        _wait_versions(pool, {0: 1, 1: 1, 2: 1})
        assert [_version_of(c) for _ in range(4)] == [1.0] * 4

        pool.set_canary([1], version=2, pct=0)
        _wait_versions(pool, {0: 1, 1: 2, 2: 1})
        assert [_version_of(c) for _ in range(4)] == [1.0] * 4
        assert pool.canary_stats()["baseline"]["n"] >= 1
        assert pool.promote_canary() == 2
        assert pool.watermark() == 2 and pool.canary() is None
        _wait_versions(pool, {0: 2, 1: 2, 2: 2})
        assert [_version_of(c) for _ in range(4)] == [2.0] * 4


def test_set_canary_validates_arm():
    pool = _bare_pool([0, 1])
    with pytest.raises(ValueError):
        pool.set_canary([5], version=2, pct=10)  # not live
    with pytest.raises(ValueError):
        pool.set_canary([0, 1], version=2, pct=10)  # no baseline left
    with pytest.raises(RuntimeError):
        pool.promote_canary()  # nothing open
    with pytest.raises(RuntimeError):
        pool.rollback_canary()
    assert pool.log == []


# -- the promotion gate (PromotionController) --------------------------------------

class _FakeLedger:
    def __init__(self):
        self.seen = set()

    def done(self, feed, unit):
        return (feed, unit) in self.seen

    def record(self, feed, unit):
        if (feed, unit) in self.seen:
            return False
        self.seen.add((feed, unit))
        return True

    def done_units(self, feed):
        return sorted(u for f, u in self.seen if f == feed)


class _FakeMgr:
    def __init__(self):
        self.kv = {}

    def get(self, key):
        return self.kv.get(key)

    def set(self, key, value):
        self.kv[key] = value


class _FakeCtx:
    """Just enough ActorContext for PromotionController.on_tick."""

    def __init__(self, group="deploy"):
        self.group = group
        self.ledger = _FakeLedger()
        self.mgr = _FakeMgr()
        self.events = []

    def kv_set(self, key, value):
        self.mgr.set(f"actor_kv:{self.group}:{key}", value)

    def emit(self, kind, payload=None):
        self.events.append((kind, payload))


def _eval_result(ctx, step, metrics):
    ctx.mgr.set(f"actor_kv:eval:eval_result:{step}",
                {"step": step, "metrics": metrics})


def test_controller_blesses_passing_step_once(tmp_path):
    from tensorflowonspark_tpu_torch.workloads.deploy_loop import (
        PromotionController,
    )

    d = str(tmp_path / "ckpt")
    _save(d, 1)
    ctrl, ctx = PromotionController(d, eval_group="eval"), _FakeCtx()
    ctrl.on_tick(ctx)  # no eval result yet: it waits
    assert ckpt.read_manifest(d, 1) is None
    _eval_result(ctx, 1, {"loss": 0.5})
    ctrl.on_tick(ctx)
    assert ckpt.verify_manifest(d, 1) == (True, "ok")
    assert _jax().verify_manifest(d, 1) == (True, "ok")
    assert ckpt.read_manifest(d, 1)["score"] == pytest.approx(0.5)
    assert ctrl.last == {"step": 1, "blessed": True, "score": 0.5,
                         "why": "pass"}
    assert [k for k, _p in ctx.events] == ["deploy/gate"]
    ctrl.on_tick(ctx)  # exactly once: no second gate event
    assert len(ctx.events) == 1


def test_controller_quarantines_nan_and_gate_max(tmp_path, monkeypatch):
    from tensorflowonspark_tpu_torch.workloads.deploy_loop import (
        PromotionController,
    )

    d = str(tmp_path / "ckpt")
    ctrl, ctx = PromotionController(d, eval_group="eval"), _FakeCtx()
    _save(d, 1)
    _eval_result(ctx, 1, {"loss": float("nan")})
    ctrl.on_tick(ctx)
    assert "tombstoned" in ckpt.verify_manifest(d, 1)[1]
    assert ctrl.last["blessed"] is False
    monkeypatch.setenv("TFOS_DEPLOY_GATE_MAX", "1.0")
    _save(d, 2)
    _eval_result(ctx, 2, {"loss": 3.0})
    ctrl.on_tick(ctx)
    assert "tombstoned" in ckpt.verify_manifest(d, 2)[1]
    _save(d, 3)
    _eval_result(ctx, 3, {"loss": 0.9})
    ctrl.on_tick(ctx)
    assert ckpt.verify_manifest(d, 3)[0]
    assert ckpt.blessed_steps(d) == [3] == _jax().blessed_steps(d)


def test_controller_skips_prejudged_manifest(tmp_path):
    from tensorflowonspark_tpu_torch.workloads.deploy_loop import (
        PromotionController,
    )

    d = str(tmp_path / "ckpt")
    _save(d, 1)
    ckpt.bless_checkpoint(d, 1, score=0.7)
    ctrl, ctx = PromotionController(d, eval_group="eval"), _FakeCtx()
    ctrl.on_tick(ctx)
    assert ctx.ledger.done("deploy_gate", 1)
    assert ctx.events == []  # adopted silently
    assert ckpt.read_manifest(d, 1)["score"] == pytest.approx(0.7)


# -- the rollout state machine (DeployLoop), held against the JAX loop ----------------

def _feed(pool, arm, ok=0, errors=0, ms=5.0):
    for _ in range(ok):
        pool._account({"t": time.monotonic() - ms / 1e3, "arm": arm},
                      ok=True)
    for _ in range(errors):
        pool._account({"t": time.monotonic() - ms / 1e3, "arm": arm},
                      ok=False)


def _mods(pkg):
    if pkg == "port":
        from tensorflowonspark_tpu_torch.workloads import deploy_loop as DL

        return ckpt, DL, faults
    from tensorflowonspark_tpu.utils import faults as jfaults
    from tensorflowonspark_tpu.workloads import deploy_loop as DL

    return _jax(), DL, jfaults


def _both(tmp_path, scenario):
    """Run ``scenario(pkg, d, pool, C, DL, F)`` for the port and for the
    JAX package, each over its own checkpoint dir and pool; returns
    ``{pkg: (scenario's result, the pool's sends)}``."""
    out = {}
    for pkg in ("port", "jax"):
        C, DL, F = _mods(pkg)
        F._reset_for_tests()
        d = str(tmp_path / pkg)
        pool = _bare_pool([0, 1, 2], pkg)
        out[pkg] = (scenario(pkg, d, pool, C, DL, F), list(pool.log))
        F._reset_for_tests()
    return out


def _loop(DL, pool, d, **kw):
    kw.setdefault("pct", 50)
    kw.setdefault("burn_secs", 5.0)
    kw.setdefault("min_samples", 3)
    return DL.DeployLoop(pool, d, **kw)


def _verdicts(loop):
    """The loop's verdicts with each reason cut to its kind (the part
    before its first ':')."""
    return [(v["step"], v["verdict"],
             [r.split(":")[0] for r in v["reasons"]]) for v in loop.history]


def _assert_same(out):
    (port, port_log), (jax_, jax_log) = out["port"], out["jax"]
    assert port == jax_
    assert port_log == jax_log


def test_deploy_bootstrap_promotes_first_blessed(tmp_path):
    def scenario(pkg, d, pool, C, DL, F):
        _save(d, 1, mod=C)
        C.bless_checkpoint(d, 1, score=0.5)
        loop = _loop(DL, pool, d)
        row = loop.pump(now=0.0)
        assert row["state"] == "idle" and row["watermark"] == 1
        assert loop.promotions == 1
        assert loop.last_verdict["reasons"] == ["bootstrap"]
        return _verdicts(loop)

    out = _both(tmp_path, scenario)
    _assert_same(out)
    # the whole pool pinned: every replica got a pinned reload
    assert out["port"][1] == [(i, ("reload", 1)) for i in (0, 1, 2)]


def test_deploy_promotes_clean_candidate(tmp_path):
    def scenario(pkg, d, pool, C, DL, F):
        _save(d, 1, mod=C)
        C.bless_checkpoint(d, 1, score=0.5)
        loop = _loop(DL, pool, d)
        loop.recover()
        assert pool.watermark() == 1 and loop.promotions == 0
        _save(d, 2, mod=C)
        C.bless_checkpoint(d, 2, score=0.45)
        assert loop.pump(now=100.0)["state"] == "burn"
        assert pool.canary() == {"replicas": (0,), "version": 2,
                                 "pct": 50.0}
        _feed(pool, "canary", ok=10)
        _feed(pool, "baseline", ok=10)
        assert loop.pump(now=101.0)["state"] == "burn"  # window open
        assert loop.pump(now=200.0)["state"] == "idle"
        assert pool.watermark() == 2 and loop.promotions == 1
        assert loop.last_verdict["verdict"] == "promote"
        assert C.verify_manifest(d, 2)[0]  # promoted, not tombstoned
        return _verdicts(loop)

    _assert_same(_both(tmp_path, scenario))


def test_deploy_rolls_back_on_eval_regression(tmp_path):
    def scenario(pkg, d, pool, C, DL, F):
        _save(d, 1, mod=C)
        C.bless_checkpoint(d, 1, score=0.5)
        _save(d, 2, mod=C)
        C.bless_checkpoint(d, 2, score=5.0)  # far past the 10% tolerance
        loop = _loop(DL, pool, d)
        pool.set_watermark(1)
        loop.pump(now=0.0)
        _feed(pool, "canary", ok=10)
        _feed(pool, "baseline", ok=10)
        assert loop.pump(now=50.0)["state"] == "idle"
        assert loop.rollbacks == 1 and loop.promotions == 0
        assert pool.watermark() == 1 and pool.canary() is None
        assert any("eval regression" in r
                   for r in loop.last_verdict["reasons"])
        assert "tombstoned" in C.verify_manifest(d, 2)[1]
        assert loop.pump(now=60.0)["state"] == "idle"  # never re-offered
        return _verdicts(loop)

    _assert_same(_both(tmp_path, scenario))


def test_deploy_rolls_back_on_slo_breach(tmp_path):
    def scenario(pkg, d, pool, C, DL, F):
        _save(d, 1, mod=C)
        C.bless_checkpoint(d, 1, score=0.5)
        _save(d, 2, mod=C)
        C.bless_checkpoint(d, 2, score=0.5)
        loop = _loop(DL, pool, d)
        pool.set_watermark(1)
        loop.pump(now=0.0)
        _feed(pool, "canary", ok=10, errors=10)
        _feed(pool, "baseline", ok=20)
        loop.pump(now=50.0)
        assert loop.rollbacks == 1
        assert any("slo deploy_availability" in r
                   for r in loop.last_verdict["reasons"])
        assert "tombstoned" in C.verify_manifest(d, 2)[1]
        return loop.last_verdict["reasons"], _verdicts(loop)

    _assert_same(_both(tmp_path, scenario))


def test_deploy_insufficient_traffic_fails_safe(tmp_path):
    def scenario(pkg, d, pool, C, DL, F):
        _save(d, 1, mod=C)
        C.bless_checkpoint(d, 1, score=0.5)
        _save(d, 2, mod=C)
        C.bless_checkpoint(d, 2, score=0.5)
        loop = _loop(DL, pool, d)
        pool.set_watermark(1)
        loop.pump(now=0.0)
        loop.pump(now=50.0)  # the burn ended with no canary sample
        assert loop.rollbacks == 1
        assert any("insufficient canary traffic" in r
                   for r in loop.last_verdict["reasons"])
        return loop.last_verdict["reasons"], _verdicts(loop)

    _assert_same(_both(tmp_path, scenario))


def test_deploy_latency_regression_guard(tmp_path):
    def scenario(pkg, d, pool, C, DL, F):
        _save(d, 1, mod=C)
        C.bless_checkpoint(d, 1, score=0.5)
        _save(d, 2, mod=C)
        C.bless_checkpoint(d, 2, score=0.5)
        loop = _loop(DL, pool, d, lat_tol=0.5)
        pool.set_watermark(1)
        loop.pump(now=0.0)
        _feed(pool, "canary", ok=10, ms=500.0)   # 25x the baseline p95
        _feed(pool, "baseline", ok=10, ms=20.0)
        loop.pump(now=50.0)
        assert loop.rollbacks == 1
        assert any("latency regression" in r
                   for r in loop.last_verdict["reasons"])
        return _verdicts(loop)

    _assert_same(_both(tmp_path, scenario))


def test_deploy_fault_sites_rearm_and_retry(tmp_path, monkeypatch):
    """An injected fault at a deploy site leaves the state machine as it
    was; the next pump retries the same transition."""
    monkeypatch.setenv("TFOS_FAULT_PLAN",
                       "deploy.canary:exc@1,deploy.promote:exc@1")

    def scenario(pkg, d, pool, C, DL, F):
        _save(d, 1, mod=C)
        C.bless_checkpoint(d, 1, score=0.5)
        _save(d, 2, mod=C)
        C.bless_checkpoint(d, 2, score=0.45)
        loop = _loop(DL, pool, d)
        pool.set_watermark(1)
        with pytest.raises(F.FaultInjected):
            loop.pump(now=0.0)
        assert loop.state == "idle" and pool.canary() is None
        assert loop.pump(now=1.0)["state"] == "burn"  # retried
        _feed(pool, "canary", ok=10)
        _feed(pool, "baseline", ok=10)
        with pytest.raises(F.FaultInjected):
            loop.pump(now=50.0)  # the promote commit faulted
        assert loop.state == "burn" and pool.watermark() == 1
        assert loop.pump(now=51.0)["state"] == "idle"  # retried, won
        assert pool.watermark() == 2 and loop.promotions == 1
        return _verdicts(loop)

    _assert_same(_both(tmp_path, scenario))


def test_deploy_table_reports_live_loops(tmp_path):
    def scenario(pkg, d, pool, C, DL, F):
        _save(d, 1, mod=C)
        C.bless_checkpoint(d, 1, score=0.5)
        loop = _loop(DL, pool, d)
        loop.pump(now=0.0)
        rows = [r for r in DL.deploy_table() if r["ckpt_dir"] == d]
        assert len(rows) == 1
        assert rows[0]["watermark"] == 1 and rows[0]["state"] == "idle"
        assert rows[0]["promotions"] == 1
        if pkg == "port":
            # /statusz's deploy section, and tfos-top-torch's --deploy
            # pane of it equal to the JAX tool's pane of the same status
            from tensorflowonspark_tpu.obs import top as jtop

            from tensorflowonspark_tpu_torch.obs import http as obs_http
            from tensorflowonspark_tpu_torch.obs import top

            statusz = obs_http.ObsServer(cluster=None, port=0,
                                         interval=999).render_statusz()
            assert [r for r in statusz["deploy"]
                    if r["ckpt_dir"] == d] == rows
            pane = top.render_deploy(statusz)
            assert "promoted=1" in pane
            assert pane == jtop.render_deploy(statusz)
        row = dict(rows[0])
        row.pop("ckpt_dir")
        return row

    _assert_same(_both(tmp_path, scenario))


def test_deploy_chaos_smoke_converges(tmp_path, monkeypatch):
    """A seeded fault plan over the deploy sites never wedges the
    rollout, and the port's loop resolves every step at the same pump,
    with the same pool calls, as the JAX loop under the same plan."""
    script = [(1, 0.50), (2, 0.45), (3, 5.0), (4, 0.40)]
    for seed in (3, 11, 29):
        monkeypatch.setenv("TFOS_FAULT_PLAN", faults.random_plan(
            seed, sites=faults.DEPLOY_CHAOS_SITES))

        def scenario(pkg, d, pool, C, DL, F):
            loop = _loop(DL, pool, d)
            now, resolved = 0.0, []
            for step, score in script:
                _save(d, step, mod=C)
                C.bless_checkpoint(d, step, score=score)
                for _ in range(200):
                    now += 1.0
                    if loop.state == "burn":
                        _feed(pool, "canary", ok=2)
                        _feed(pool, "baseline", ok=2)
                    try:
                        loop.pump(now=now)
                    except F.FaultInjected:
                        continue  # the chaos contract: retry next pump
                    ok, why = C.verify_manifest(d, step)
                    if loop.state == "idle" and (
                            pool.watermark() == step
                            or (not ok and "tombstoned" in (why or ""))):
                        resolved.append((step, now))
                        break
                else:
                    raise AssertionError(f"seed {seed}: step {step} never "
                                         f"resolved ({loop.state})")
            assert pool.watermark() == 4, f"seed {seed}"
            assert (loop.promotions, loop.rollbacks) == (3, 1), seed
            assert pool.canary() is None
            assert "tombstoned" in C.verify_manifest(d, 3)[1]
            return resolved, _verdicts(loop)

        _assert_same(_both(tmp_path / str(seed), scenario))


# -- the whole loop, live ------------------------------------------------------

def _eval_loss(tree, step):
    """The JAX test's ``eval_fn`` (the members import it)."""
    return {"loss": float(np.asarray(tree["loss"])), "step": step}


def _save_versioned(d, step, loss):
    return ckpt.save_checkpoint(
        d, {"version": np.array(float(step)),
            "loss": np.array(float(loss))}, step=step)


def _wait_for(cond, what, timeout=HANG):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} not reached within {timeout}s")


def _pump_until(loop, cond, what, timeout=HANG):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        loop.pump()
        if cond(loop):
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} not reached within {timeout}s "
                         f"(status={loop.status()})")


def test_deploy_e2e_gate_canary_rollback(tmp_path, monkeypatch):
    """The JAX slow-lane test on the port, in tier 1: checkpoints gated
    once, a bootstrap pin, a clean candidate canaried and promoted, a
    regressed one canaried and rolled back (tombstone, flight dump,
    rollback counter), a NaN one quarantined at the gate, with client
    traffic throughout and no request dropped."""
    from tensorflowonspark_tpu_torch.actors import (
        ActorSystem,
        SupervisionPolicy,
    )
    from tensorflowonspark_tpu_torch.serving import replicas as R
    from tensorflowonspark_tpu_torch.serving import server as S
    from tensorflowonspark_tpu_torch.utils import metrics_registry, telemetry
    from tensorflowonspark_tpu_torch.workloads.deploy_loop import (
        DeployLoop,
        PromotionController,
    )
    from tensorflowonspark_tpu_torch.workloads.eval_sidecar import (
        EvalSidecar,
    )

    d = str(tmp_path / "ckpt")
    tdir = str(tmp_path / "telemetry")
    monkeypatch.setenv(telemetry.DIR_ENV, tdir)
    monkeypatch.setenv(telemetry.NODE_ENV, "deploy-driver")
    monkeypatch.delenv(telemetry.SPOOL_ENV, raising=False)
    monkeypatch.delenv(telemetry.ROLE_ENV, raising=False)
    monkeypatch.setenv(metrics_registry.PORT_ENV, "0")
    metrics_registry.reset()
    monkeypatch.setenv("TFOS_SERVE_RELOAD_SECS", "0.2")

    _save_versioned(d, 1, loss=0.5)
    pol = SupervisionPolicy(heartbeat_secs=0.2, stale_secs=5.0,
                            tick_secs=0.1)
    spec = R.ModelSpec(predict=_serve_version, ckpt_dir=d, device="cpu")
    stop = threading.Event()
    served, drops = [], []

    with _bounded(), S.Server(spec, num_replicas=3, max_batch=8,
                              max_delay_ms=5, env=ENV,
                              request_timeout=HANG) as srv, \
            ActorSystem(2, env=ENV) as sys_:
        pool, c = srv.pool, srv.client()

        def traffic():
            while not stop.is_set():
                try:
                    served.append(_version_of(c))
                except Exception as e:  # noqa: BLE001 - any loss counts
                    drops.append(repr(e))

        sys_.spawn(EvalSidecar(d, _eval_loss), "eval", policy=pol)
        sys_.spawn(PromotionController(d), "deploy", policy=pol)
        loop = DeployLoop(pool, d, pct=60, canary_count=1, burn_secs=3.0,
                          min_samples=3, lat_tol=10.0)
        assert loop.recover() is None  # nothing blessed yet
        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        try:
            _wait_for(lambda: ckpt.read_manifest(d, 1) is not None,
                      "step 1 gate")
            assert ckpt.verify_manifest(d, 1)[0]
            _pump_until(loop, lambda lp: pool.watermark() == 1,
                        "bootstrap watermark")
            assert loop.promotions == 1

            _save_versioned(d, 2, loss=0.4)
            _wait_for(lambda: ckpt.read_manifest(d, 2) is not None,
                      "step 2 gate")
            _pump_until(loop, lambda lp: lp.promotions >= 2
                        and lp.state == "idle", "step 2 promotion")
            assert pool.watermark() == 2
            assert ckpt.verify_manifest(d, 2)[0]
            _wait_versions(pool, {0: 2, 1: 2, 2: 2})

            _save_versioned(d, 3, loss=30.0)
            _wait_for(lambda: ckpt.read_manifest(d, 3) is not None,
                      "step 3 gate")
            assert ckpt.verify_manifest(d, 3)[0]  # blessed: gate passed
            _pump_until(loop, lambda lp: lp.rollbacks >= 1,
                        "step 3 rollback")
            assert pool.watermark() == 2 and pool.canary() is None
            assert any("eval regression" in r
                       for r in loop.last_verdict["reasons"])
            assert "tombstoned" in ckpt.verify_manifest(d, 3)[1]
            _wait_versions(pool, {0: 2, 1: 2, 2: 2})

            _save_versioned(d, 4, loss=float("nan"))
            _wait_for(lambda: ckpt.read_manifest(d, 4) is not None,
                      "step 4 gate")
            assert "tombstoned" in ckpt.verify_manifest(d, 4)[1]
            for _ in range(5):
                row = loop.pump()
                assert row["state"] == "idle" and row["candidate"] is None
                time.sleep(0.1)
            assert pool.watermark() == 2
            assert _version_of(c) == 2.0
        finally:
            stop.set()
            t.join(timeout=30)

    assert not drops, f"dropped requests: {drops[:5]}"
    assert len(served) > 20
    assert {1.0, 2.0} <= set(served)  # traffic crossed the promotion
    assert 3.0 in served  # and the canary arm took traffic
    snap = metrics_registry.snapshot()

    def total(name):
        return sum(s["value"] for s in snap.get(name, {}).get("series", ()))

    assert total("tfos_deploy_promotions_total") >= 2
    assert total("tfos_deploy_rollbacks_total") == 1
    telemetry.flush()
    dumps = []
    for root, _dirs, files in os.walk(tdir):
        for name in files:
            if name.startswith("flight-") and name.endswith(".json"):
                with open(os.path.join(root, name), encoding="utf-8") as f:
                    dumps.append(json.load(f))
    assert any(dp["trigger"] == telemetry.DEPLOY_ROLLBACK
               and "eval regression" in (dp["reason"] or "")
               for dp in dumps), f"no rollback flight dump in {tdir}"


def test_run_deploy_loop_absorbs_faults(tmp_path, monkeypatch):
    """The JAX slow-lane test in tier 1: ``run_deploy_loop`` spawns the
    sidecar and the controller in its own system, recovers, and absorbs
    an injected promote fault; the summary shows the promotion."""
    from tensorflowonspark_tpu_torch.workloads.deploy_loop import (
        run_deploy_loop,
    )

    d = str(tmp_path / "ckpt")
    _save_versioned(d, 1, loss=0.5)
    faults._reset_for_tests()
    monkeypatch.setenv("TFOS_FAULT_PLAN", "deploy.promote:exc@1")
    pool = _bare_pool([0, 1, 2])
    with _bounded():
        summary = run_deploy_loop(
            pool, d, _eval_loss, duration=HANG, poll_secs=0.1,
            stop_when=lambda lp: lp.promotions >= 1, env=ENV,
            pct=50, burn_secs=1.0, min_samples=1)
    faults._reset_for_tests()
    assert summary["watermark"] == 1
    assert summary["promotions"] == 1 and summary["rollbacks"] == 0
    assert pool.watermark() == 1
    assert ckpt.verify_manifest(d, 1)[0]
    assert pool.log == [(i, ("reload", 1)) for i in (0, 1, 2)]
