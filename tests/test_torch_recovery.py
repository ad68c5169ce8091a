"""PyTorch port, supervised recovery, on the CPU, held against the JAX
package where the two share a unit and against in-process replays
where they run:

- ``cluster._elastic_template`` gives the JAX package's template for a
  lost chief or master, dropped ps and evaluator seats, an emptied job
  and a re-grow;
- the rendezvous server's epoch fence REJECTs a stale registration with
  the JAX server's reply and the client raises the JAX client's error;
  ``reset`` keeps the feed ledger, ``resize`` moves the count that
  completes the cluster, ``QNUM`` answers as the JAX server does;
- ``gpu_info.claim_gpus`` follows ``tpu_info.claim_chips``' decision
  table (the scheduler's resources, the K8s rule, the host scan, the
  raise), both packages' ``_task_resources`` patched;
- the engine's ``alive_executors`` and ``retire_executors``, the node's
  epoch-aware guard and ring name, and ``ctx.restore_latest`` against
  the JAX context's;
- ``transformer_spark.load_train_state`` puts a checkpoint's Adam state
  into a fresh optimizer as the live one held it (the step and each
  param's moments), and the JAX package's ``unpack_pytree`` reads the
  same tree as ``optax.adam``'s ``(count, mu, nu)``, whose next steps
  give the port's losses;
- end to end on a 2-executor ``LocalEngine`` (a ps node on executor 0,
  the tiny transformer's trainer on executor 1): executor 1 SIGKILLed
  while it feeds (``feed.put:kill@6``) heals with ``restarts=1``:
  exactly one recovery and one respawn, every partition in the ledger
  once, no feed ring left in ``/dev/shm``, the ps node quiesced and
  relaunched in epoch 1, the epoch-1
  trainer resumed at its last checkpoint (step > 0), and its losses
  equal an in-process replay of the same rows from that checkpoint and
  the JAX package's optax steps from it;
  with ``restarts=0`` the same kill fails ``train()`` with
  ``TaskError``;
- a heal of two data-parallel trainers: the re-feed is dealt round
  robin over them, both stop on the shorter share, and at most the odd
  re-fed partition is drained untrained; no row is trained twice;
- an executor SIGKILLed from outside while it waits on its inbox heals:
  its respawn reads a fresh inbox, and spread and shared-queue jobs
  finish.

Why the first heal has one trainer: two data-parallel trainers each
pull their own partitions up to three batches ahead of the step they
share, so the survivor of a kill may have consumed more partitions than
the dead one; the re-feed is then uneven (the last test measures it).
(``tests/test_torch_elastic.py`` shrinks a two-trainer job, where the
survivor takes every partition left.)  Why the 6th put: the prefetch
pulls at most three batches ahead of the step (two staged, one in the
prefetch thread's hand), so when executor 1 starts its 6th partition
(its 5th consumed) the trainer has finished and saved step 1.  The
respawned executor counts its puts from zero and re-feeds three
partitions, so the plan cannot fire twice.  Nothing waits on a
wall-clock deadline: ``reservation_timeout`` and ``feed_timeout`` only
bound the waits.
"""

import glob
import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import (  # noqa: E402
    gpu_info,
    node,
    rendezvous,
)
from tensorflowonspark_tpu_torch.engine import (  # noqa: E402
    LocalEngine,
    TaskError,
)
from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    transformer_spark,
)
from tensorflowonspark_tpu_torch.utils import faults  # noqa: E402

pytestmark = pytest.mark.faults

TIMEOUT = 90
LOSS_RTOL = 1e-4
TINY = dict(vocab_size=64, dim=32, n_layers=1, n_heads=2, max_seq=16,
            dtype="float32")


# -- the template ------------------------------------------------------------

@pytest.mark.parametrize("template,alive", [
    ({"chief": [0], "worker": [1, 2, 3]}, [1, 2, 3]),      # chief lost
    ({"master": [0], "worker": [1, 2]}, [1, 2]),           # master lost
    ({"ps": [0], "worker": [1, 2]}, [1, 2]),               # ps dropped
    ({"ps": [0], "evaluator": [1], "worker": [2, 3]}, [0, 3]),
    ({"chief": [0], "worker": [1]}, [0]),                  # job emptied
    ({"chief": [0], "ps": [1]}, [1]),                      # no worker left
    ({"chief": [0], "ps": [1], "worker": [2, 3]}, [0, 1, 2, 3]),  # re-grow
], ids=["chief_lost", "master_lost", "ps_dropped", "side_and_worker",
        "job_emptied", "coordinator_unfilled", "regrow_identity"])
def test_elastic_template_matches_jax(template, alive):
    from tensorflowonspark_tpu.cluster import _elastic_template

    want = _elastic_template(template, alive)
    assert TFCluster._elastic_template(template, alive) == want
    if set(alive) == {i for ids in template.values() for i in ids}:
        assert want == template


# -- the rendezvous epoch fence -----------------------------------------------

def _raw(addr, msg):
    ms = rendezvous.MessageSocket()
    with socket.create_connection(tuple(addr), timeout=10) as s:
        ms.send(s, msg)
        return ms.receive(s)


def test_rendezvous_epoch_fence_and_resize_match_jax():
    from tensorflowonspark_tpu import rendezvous as JR

    servers = {"jax": JR.Server(2), "torch": rendezvous.Server(2)}
    addrs = {k: s.start() for k, s in servers.items()}
    try:
        seen = {}
        for k, s in servers.items():
            a = addrs[k]
            out = [_raw(a, {"type": "REG", "data": {"executor_id": 0},
                            "epoch": 0}),
                   _raw(a, {"type": "PDONE", "feed": "input", "part": 3}),
                   _raw(a, {"type": "QNUM"})]
            s.reset(1)
            out += [_raw(a, {"type": "REG", "data": {"executor_id": 1},
                             "epoch": 0}),
                    _raw(a, {"type": "QNUM"}),
                    _raw(a, {"type": "PQUERY", "feed": "input"}),
                    _raw(a, {"type": "REG", "data": {"executor_id": 1},
                             "epoch": 1}),
                    _raw(a, {"type": "QUERY"})]
            s.resize(1)
            out += [_raw(a, {"type": "QUERY"}), _raw(a, {"type": "QNUM"})]
            # a respawned node re-registering within the epoch replaces
            # its reservation
            _raw(a, {"type": "REG", "data": {"executor_id": 1, "n": 2},
                     "epoch": 1})
            out.append(_raw(a, {"type": "QINFO"}))
            assert s.epoch == 1
            seen[k] = out
        assert seen["torch"] == seen["jax"]
        assert seen["torch"][3] == {"type": "REJECT", "data": {"epoch": 1}}
        assert seen["torch"][5] == {"type": "PQUERY", "data": [3]}
        # the client raises the JAX client's error on a REJECT
        errs = {}
        for k, mod in (("jax", JR), ("torch", rendezvous)):
            c = mod.Client(addrs[k])
            try:
                with pytest.raises(RuntimeError) as e:
                    c.register({"executor_id": 5}, epoch=0)
                errs[k] = str(e.value)
                assert c.register({"executor_id": 5}, epoch=1) == \
                    {"type": "OK"}
            finally:
                c.close()
        assert errs["torch"] == errs["jax"]
        assert "QNUM" in rendezvous.Client.IDEMPOTENT
    finally:
        for s in servers.values():
            s.stop()


# -- gpu_info against tpu_info ------------------------------------------------

@pytest.mark.parametrize("resources,num,k8s,host,index", [
    ({"gpu": ["0", "1"]}, 0, False, 4, -1),   # the scheduler's, all
    ({"gpu": ["0", "1"]}, 1, False, 4, -1),   # cut to the request
    ({"tpu": ["2", "3"]}, 2, False, 0, 0),
    ({"accelerator": ["3"]}, 1, True, 0, 0),  # K8s: the scheduler's
    ({"gpu": ["0"]}, 2, False, 4, 0),         # the scheduler offers fewer
    (None, 1, False, 4, 1),                   # the host, by worker index
    (None, 2, False, 4, 1),
    (None, 2, False, 4, 2),                   # past the host's supply
    (None, 1, True, 4, 0),                    # K8s: no host scan
    (None, 0, True, 4, 0),
    (None, 0, False, 4, 0),                   # nothing asked, nothing taken
    ({}, 1, False, 0, 0),                     # no GPU anywhere
], ids=["sched_all", "sched_cut", "sched_tpu", "k8s_sched", "sched_short",
        "host_1", "host_2", "host_short", "k8s_no_scan", "k8s_none",
        "none", "no_gpu"])
def test_gpu_claim_decision_table_matches_tpu_info(monkeypatch, resources,
                                                   num, k8s, host, index):
    from tensorflowonspark_tpu import tpu_info

    for name in ("TPU_VISIBLE_CHIPS", "TPU_CHIPS_PER_PROCESS_BOUNDS",
                 "TPU_PROCESS_BOUNDS", gpu_info.MASK_ENV,
                 gpu_info.INHERITED_ENV, "SPARK_EXECUTOR_POD_IP"):
        monkeypatch.delenv(name, raising=False)
    if k8s:
        monkeypatch.setenv("SPARK_EXECUTOR_POD_IP", "10.0.0.1")
    monkeypatch.setenv("TFOS_TPU_CHIPS_PER_HOST", str(host))
    monkeypatch.setenv(gpu_info.COUNT_ENV, str(host))
    monkeypatch.setattr(tpu_info, "_task_resources", lambda: resources)
    monkeypatch.setattr(gpu_info, "_task_resources", lambda: resources)
    monkeypatch.setattr(tpu_info, "count_chips", lambda: host)

    def claim(fn):
        try:
            return [str(x) for x in fn(num, index)]
        except RuntimeError:
            return "raises"

    want = claim(tpu_info.claim_chips)
    got = claim(gpu_info.claim_gpus)
    assert got == want
    if got not in ("raises", []):
        assert os.environ[gpu_info.MASK_ENV] == ",".join(got)


# -- engine and node units ----------------------------------------------------

def _where(it):
    list(it)
    return [int(os.environ["TFOS_EXECUTOR_INDEX"])]


def _die(it):
    list(it)
    os.kill(os.getpid(), 9)


def test_engine_retires_slots_and_reports_liveness():
    """Spread jobs skip a retired slot, which is never respawned; a dead
    slot leaves ``alive_executors``; ``retire_executors([])`` (a
    re-grow) puts it back and the heal respawns it."""
    engine = LocalEngine(2, env={"OMP_NUM_THREADS": "1"})
    try:
        assert engine.alive_executors() == [0, 1]
        engine.retire_executors([1])
        ran = engine.parallelize(range(3), 3).map_partitions(_where) \
            .collect(spread=True)
        assert ran == [0, 0, 0]
        # dies inside a task: a kill from outside may land while the
        # executor holds its inbox's lock, which no respawn could take
        with pytest.raises(TaskError, match="died"):
            engine.parallelize([0], 1).foreach_partition(_die,
                                                         placement=[1])
        engine._procs[1].join(10)
        assert engine.alive_executors() == [0]
        assert engine.ensure_executors() == []
        with pytest.raises(TaskError, match="retired"):
            engine._respawn_executor(1)
        engine.retire_executors([])
        assert engine.ensure_executors() == [1]
        assert engine.alive_executors() == [0, 1]
        ran = engine.parallelize(range(2), 2).map_partitions(_where) \
            .collect(spread=True)
        assert ran == [0, 1]
    finally:
        engine.stop()


def _idle_kill(engine, index, idle_s=0.2):
    """SIGKILL executor ``index`` from outside while it waits on its
    inbox (a task ran on every executor first, so each is past its
    boot and back in ``get``) ``idle_s`` seconds after that task."""
    engine.parallelize(range(engine.num_executors),
                       engine.num_executors).collect(spread=True)
    time.sleep(idle_s)
    os.kill(engine._procs[index].pid, signal.SIGKILL)
    engine._procs[index].join(10)
    assert not engine._procs[index].is_alive()


def _bounded(fn, limit):
    """``fn()``'s result, run on a thread that must end within ``limit``
    seconds: a regression fails the test instead of hanging it."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit)
    assert not t.is_alive(), f"no answer within {limit} s"
    if err:
        raise err[0]
    return out[0]


def test_outside_kill_while_idle_heals():
    """Executor 1 SIGKILLed by the test process while it waits on its
    inbox: ``ensure_executors`` respawns it on a fresh inbox, a spread
    job's task 1 runs on it, and a shared-queue job of four tasks
    finishes.  The dead process held its inbox's reader lock; a respawn
    that kept that inbox would never read again."""
    engine = LocalEngine(2, env={"OMP_NUM_THREADS": "1"})
    try:
        # three kills, each at another point of the idle loop
        for idle_s in (0.05, 0.13, 0.21):
            _idle_kill(engine, 1, idle_s)
            t0 = time.monotonic()
            assert engine.ensure_executors() == [1]
            ran = _bounded(lambda: engine.parallelize(range(2), 2)
                           .map_partitions(_where).collect(spread=True), 20)
            assert ran == [0, 1]
            ran = _bounded(lambda: engine.parallelize(range(4), 4)
                           .map_partitions(_where).collect(), 20)
            assert len(ran) == 4 and set(ran) <= {0, 1}
            print(f"healed in {time.monotonic() - t0:.3f} s")
    finally:
        engine.stop()


def test_engine_retires_slots_after_an_outside_kill():
    """The retire-and-regrow flow of the test above, the slot killed
    from outside while idle: the dead slot leaves ``alive_executors``,
    stays out while retired, and the re-grow's respawn reads again."""
    engine = LocalEngine(2, env={"OMP_NUM_THREADS": "1"})
    try:
        _idle_kill(engine, 1)
        assert engine.alive_executors() == [0]
        engine.retire_executors([1])
        assert engine.ensure_executors() == []
        ran = _bounded(lambda: engine.parallelize(range(3), 3)
                       .map_partitions(_where).collect(spread=True), 60)
        assert ran == [0, 0, 0]
        engine.retire_executors([])
        assert engine.ensure_executors() == [1]
        ran = _bounded(lambda: engine.parallelize(range(2), 2)
                       .map_partitions(_where).collect(spread=True), 60)
        assert ran == [0, 1]
    finally:
        engine.stop()


class _FakeMgr:
    def __init__(self, state):
        self.state = state

    def get(self, key):
        return self.state if key == "state" else None


class _Stop(Exception):
    pass


def test_node_guard_is_epoch_aware(monkeypatch):
    """A live node of the same cluster and epoch refuses a second one; a
    node of an earlier epoch is torn down before the new one boots; the
    ring's name carries the epoch, as the JAX package's does."""
    from tensorflowonspark_tpu_torch.utils import telemetry

    meta = {"id": 0xabc, "epoch": 0, "cluster_template": {"worker": [0]},
            "authkey": "00" * 16}
    monkeypatch.setenv(telemetry.ROLE_ENV, "driver")  # keep our identity
    torn = []
    monkeypatch.setattr(node, "_teardown_node_state",
                        lambda: torn.append(True))

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(node.tfmanager, "start", stop)
    monkeypatch.setattr(node._NodeState, "mgr", _FakeMgr("running"))
    monkeypatch.setattr(node._NodeState, "cluster_id", 0xabc)
    monkeypatch.setattr(node._NodeState, "epoch", 0)
    task = node.run(None, None, meta, background=False)
    with pytest.raises(RuntimeError, match="already hosts a node"):
        task(iter([0]))
    assert torn == []
    meta["epoch"] = 1
    with pytest.raises(_Stop):
        node.run(None, None, meta, background=False)(iter([0]))
    assert torn == [True]
    assert node.feed_ring_name(0xabc, 3) == "/tfos-abc-3"
    assert node.feed_ring_name(0xabc, 3, epoch=2) == "/tfos-abc-e2-3"


def test_restore_latest_matches_jax_context(tmp_path):
    """``ctx.restore_latest`` reads the newest checkpoint as the JAX
    context's does, and an empty directory as (None, 0)."""
    from tensorflowonspark_tpu import node as JN
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    d = str(tmp_path / "ckpt")
    args = (0, "worker", 0, {}, "file://", str(tmp_path), None)
    ctx, jctx = node.TFNodeContext(*args, epoch=1), \
        JN.TFNodeContext(*args, epoch=1)
    assert ctx.restore_latest(d) == (None, 0) == jctx.restore_latest(d)
    for step in (1, 2):
        ckpt.save_checkpoint(d, {"params": {"w": np.full(3, step, np.float32)},
                                 "opt": {"00000": np.int32(step)}}, step)
    tree, step = ctx.restore_latest(d)
    jtree, jstep = jctx.restore_latest(d)
    assert step == jstep == 2
    assert ckpt._flatten(tree).keys() == ckpt._flatten(jtree).keys()
    for k, v in ckpt._flatten(jtree).items():
        np.testing.assert_array_equal(ckpt._flatten(tree)[k], v)


def test_load_train_state_restores_adam_as_torch_and_optax_hold_it(
        tmp_path):
    """Three Adam steps, the chief's checkpoint tree saved and read back,
    and ``load_train_state`` into fresh params and a fresh Adam: each
    param's step, ``exp_avg`` and ``exp_avg_sq`` equal the live
    optimizer's, and the next two steps are the live ones to the bit.
    The JAX package's ``unpack_pytree`` reads the same tree as
    ``optax.adam``'s int32 count, ``mu`` and ``nu``, equal to the live
    moments leaf by leaf, and optax's next two steps from it give the
    port's losses."""
    from tensorflowonspark_tpu_torch.models import transformer as T
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    cfg = T.Config(**TINY)
    rows = 4
    tokens = np.random.default_rng(21).integers(
        0, TINY["vocab_size"], (5 * rows, TINY["max_seq"])).astype(np.int32)
    row_index(tokens)
    batches = [torch.from_numpy(tokens[i * rows:(i + 1) * rows]
                                .astype(np.int64)) for i in range(5)]
    params = T.init(cfg, torch.Generator().manual_seed(3), "cpu")
    _, opt = transformer_spark.make_optimizer(params)
    for b in batches[:3]:
        transformer_spark.train_step(params, opt, b, cfg)
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, transformer_spark.train_state(params, opt), 3)
    tree = ckpt.load_checkpoint(os.path.join(d, "ckpt-00000003.npz"))
    fresh = T.init(cfg, torch.Generator().manual_seed(4), "cpu")
    _, fopt = transformer_spark.make_optimizer(fresh)
    transformer_spark.load_train_state(tree, fresh, fopt)
    live = transformer_spark.param_leaves(params)
    for p, q in zip(live, transformer_spark.param_leaves(fresh)):
        a, b = opt.state[p], fopt.state[q]
        assert sorted(b) == sorted(a) == ["exp_avg", "exp_avg_sq", "step"]
        assert float(b["step"]) == float(a["step"]) == 3.0
        assert b["step"].dtype == a["step"].dtype
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(b[k].numpy(), a[k].numpy())
        np.testing.assert_array_equal(q.detach().numpy(),
                                      p.detach().numpy())
    at_save = {name: {k: opt.state[p][name].numpy().copy()
                      for k, p in ckpt._flatten_leaves(params)}
               for name in ("exp_avg", "exp_avg_sq")}
    got = [transformer_spark.train_step(fresh, fopt, b, cfg).item()
           for b in batches[3:]]
    want = [transformer_spark.train_step(params, opt, b, cfg).item()
            for b in batches[3:]]
    assert got == want
    for p, q in zip(live, transformer_spark.param_leaves(fresh)):
        np.testing.assert_array_equal(q.detach().numpy(),
                                      p.detach().numpy())

    jwant, jstate = jax_replay(tokens, d, 3, [
        [tokens[i][:transformer_spark.ROW_KEY_TOKENS]
         for i in range(k * rows, (k + 1) * rows)] for k in (3, 4)])
    adam = jstate[0]
    assert np.asarray(adam.count).dtype == np.int32 and int(adam.count) == 3
    for name, moments in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        moments = dict(ckpt._flatten_leaves(moments))
        assert sorted(moments) == sorted(at_save[name])
        for k, m in moments.items():
            np.testing.assert_array_equal(np.asarray(m), at_save[name][k],
                                          err_msg=f"{name} {k}")
    np.testing.assert_allclose(got, jwant, rtol=LOSS_RTOL)


# -- end to end ---------------------------------------------------------------

def rings_left(c):
    """The cluster's feed rings still in ``/dev/shm``, any epoch."""
    return glob.glob(f"/dev/shm/tfos-{c.cluster_meta['id'] & 0xffffffff:x}"
                     "*")


def steps_log(out_dir, executor):
    path = os.path.join(out_dir, f"steps-exec{executor}.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def row_index(tokens):
    """{first ROW_KEY_TOKENS tokens: row}, asserting they name each row."""
    k = transformer_spark.ROW_KEY_TOKENS
    index = {tuple(int(t) for t in row[:k]): i
             for i, row in enumerate(tokens)}
    assert len(index) == len(tokens), "row keys collide"
    return index


def replay(tokens, ckpt_dir, step, batches, elastic_data=None):
    """Losses of the same steps in this process: the chief's checkpoint
    at ``step``, then one optimizer step a batch (a list of row keys),
    through the trainer's own functions."""
    from tensorflowonspark_tpu_torch import elastic
    from tensorflowonspark_tpu_torch.models import transformer as T
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    cfg = T.Config(**TINY)
    index = row_index(tokens)
    if step:
        tree = ckpt.load_checkpoint(os.path.join(ckpt_dir,
                                                 f"ckpt-{step:08d}.npz"))
        params = T.params_from_jax(tree["params"], cfg, device="cpu")
    else:
        params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    _, opt = transformer_spark.make_optimizer(params)
    if step:
        transformer_spark.load_train_state(tree, params, opt)
    vg = None
    if elastic_data:
        layout = elastic.virtualize({"data": elastic_data}, ["cpu"])
        vg = layout.value_and_grad(transformer_spark.elastic_loss(cfg))
    out = []
    for keys in batches:
        batch = torch.from_numpy(np.stack(
            [tokens[index[tuple(k)]] for k in keys]).astype(np.int64))
        out.append(transformer_spark.train_step(params, opt, batch, cfg,
                                                vg).item())
    return out


def jax_replay(tokens, ckpt_dir, step, batches):
    """Losses of the same steps in the JAX package: the checkpoint at
    ``step`` read by its ``load_checkpoint``, Adam's state by its
    ``unpack_pytree`` into ``optax.adam``'s (at step 0 the trainer's
    init and a fresh Adam), then one optax step a batch (a list of row
    keys).  Also returns optax's state at ``step``."""
    import jax
    import jax.numpy as jnp
    import optax

    from tensorflowonspark_tpu.models import transformer as JT
    from tensorflowonspark_tpu.utils import checkpoint as jckpt

    cfg = JT.Config(**TINY, attn_impl="reference")
    index = row_index(tokens)
    opt = optax.adam(1e-3)
    if step:
        tree = jckpt.load_checkpoint(os.path.join(ckpt_dir,
                                                  f"ckpt-{step:08d}.npz"))
        pj = jax.tree_util.tree_map(jnp.asarray, tree["params"])
        state = jckpt.unpack_pytree(tree["opt"], opt.init(pj))
    else:  # the trainer's own init, seed 0
        from tensorflowonspark_tpu_torch.models import transformer as T

        pj = jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.numpy()),
            T.init(T.Config(**TINY), torch.Generator().manual_seed(0),
                   "cpu"))
        state = opt.init(pj)
    restored = state
    vg = jax.jit(jax.value_and_grad(lambda p, t: JT.loss_fn(p, t, cfg)))
    out = []
    for keys in batches:
        loss, g = vg(pj, jnp.asarray(np.stack(
            [tokens[index[tuple(k)]] for k in keys])))
        upd, state = opt.update(g, state)
        pj = optax.apply_updates(pj, upd)
        out.append(float(loss))
    return out, restored


def kill_engine(plan, respawns=None):
    env = {"OMP_NUM_THREADS": "2", faults.PLAN_ENV: plan,
           faults.EXECUTOR_ENV: "1"}
    old = os.environ.get("TFOS_EXECUTOR_RESPAWNS")
    if respawns is not None:
        # read by the engine in the driver, at construction
        os.environ["TFOS_EXECUTOR_RESPAWNS"] = str(respawns)
    try:
        return LocalEngine(2, env=env)
    finally:
        if respawns is not None:
            if old is None:
                os.environ.pop("TFOS_EXECUTOR_RESPAWNS")
            else:
                os.environ["TFOS_EXECUTOR_RESPAWNS"] = old


def heal_main(args, ctx):
    """The trainer on compute nodes; a ps node has nothing to run."""
    if ctx.job_name != "ps":
        transformer_spark.main_fun(args, ctx)


def _heal_args(tmp_path, batch):
    return {"config": TINY, "batch_size": batch, "device": "cpu", "seed": 0,
            "ckpt_dir": str(tmp_path / "ckpt"), "ckpt_every": 1,
            "ckpt_keep": 100, "out_dir": str(tmp_path)}


PARTS, PART_ROWS = 8, 2  # one step a partition


def test_kill_heals_with_one_recovery_and_replays_exactly(tmp_path):
    tokens = np.random.default_rng(11).integers(
        0, TINY["vocab_size"], (PARTS * PART_ROWS, TINY["max_seq"])
    ).astype(np.int32)
    row_index(tokens)
    engine = kill_engine("feed.put:kill@6")
    try:
        c = TFCluster.run(engine, heal_main, _heal_args(tmp_path, PART_ROWS),
                          num_executors=2, num_ps=1,
                          input_mode=TFCluster.InputMode.SPARK,
                          reservation_timeout=TIMEOUT, restarts=1)
        c.train(engine.parallelize(list(tokens), PARTS),
                feed_timeout=TIMEOUT)
        assert c._restarts_used == 1 and c.meta["epoch"] == 1
        assert engine._respawns == 1
        assert c.server.fed_partitions("input") == list(range(PARTS))
        assert c.meta["cluster_template"] == {"ps": [0], "worker": [1]}
        assert sorted((m["job_name"], m["executor_id"])
                      for m in c.cluster_info) == [("ps", 0), ("worker", 1)]
        c.shutdown()
        # the dead incarnation's ring was unlinked, the live one closed
        assert rings_left(c) == []
    finally:
        engine.stop()
    log = steps_log(str(tmp_path), 1)
    starts = [r for r in log if r["event"] == "start"]
    assert [r["epoch"] for r in starts] == [0, 1]
    resumed = starts[1]["resumed_step"]
    e0 = [r for r in log if r["event"] == "step" and r["epoch"] == 0]
    e1 = [r for r in log if r["event"] == "step" and r["epoch"] == 1]
    # resumed at the last step the dead trainer saved, and no later one
    assert resumed > 0
    assert resumed == max(r["step"] for r in e0 if r["save_ms"] is not None)
    assert [r["step"] for r in e1] == list(
        range(resumed + 1, resumed + 1 + len(e1)))
    # the partitions consumed after the save are lost steps; the rest
    # are trained once: every partition the re-feed sent is a step
    assert len(e1) == PARTS - 5
    want = replay(tokens, str(tmp_path / "ckpt"), resumed,
                  [r["rows"] for r in e1])
    np.testing.assert_allclose([r["loss"] for r in e1], want,
                               rtol=LOSS_RTOL)
    # the same steps in the JAX package, from the checkpoint's params and
    # Adam state as optax reads them: a restore that misplaced the
    # moments or the count would move the 2nd and 3rd losses
    jwant, jstate = jax_replay(tokens, str(tmp_path / "ckpt"), resumed,
                               [r["rows"] for r in e1])
    assert int(jstate[0].count) == resumed
    np.testing.assert_allclose([r["loss"] for r in e1], jwant,
                               rtol=LOSS_RTOL)
    # no trainer of epoch 0 is left
    assert not os.path.exists(f"/proc/{starts[0]['pid']}") or \
        _zombie(starts[0]["pid"])


def _zombie(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def test_kill_without_restarts_fails_train(tmp_path):
    """The heal test's kill with ``restarts=0``: ``train()`` fails fast
    with the engine's ``TaskError``, and no recovery is made."""
    tokens = np.random.default_rng(12).integers(
        0, TINY["vocab_size"], (PARTS * PART_ROWS, TINY["max_seq"])
    ).astype(np.int32)
    engine, c = kill_engine("feed.put:kill@6"), None
    try:
        c = TFCluster.run(engine, heal_main, _heal_args(tmp_path, PART_ROWS),
                          num_executors=2, num_ps=1,
                          input_mode=TFCluster.InputMode.SPARK,
                          reservation_timeout=TIMEOUT)
        with pytest.raises(TaskError, match="died"):
            c.train(engine.parallelize(list(tokens), PARTS),
                    feed_timeout=TIMEOUT)
        assert c._restarts_used == 0 and c.meta["epoch"] == 0
        assert engine._respawns == 0
        c.server.stop()
    finally:
        engine.stop()
        # no recovery ran to unlink the dead node's ring
        from tensorflowonspark_tpu_torch.recordio import shm

        for path in rings_left(c) if c is not None else ():
            shm.unlink(os.path.basename(path))


PARTS2 = 12  # six partitions a trainer; one step a partition


def _events(tmp_path, name):
    out = []
    for path in glob.glob(str(tmp_path / "telemetry" / "**" / "*.jsonl"),
                          recursive=True):
        with open(path) as f:
            out += [e for e in map(json.loads, filter(None, f))
                    if e.get("name") == name]
    return out


def test_two_trainer_heal_drains_the_longer_share(tmp_path, monkeypatch):
    """Two data-parallel trainers, executor 1 SIGKILLed at its 4th
    partition (``feed.put:kill@4``), healed with ``restarts=1``.  The
    re-feed deals the partitions the ledger does not hold round robin
    over the two trainers, in order, so their shares differ by one
    partition at most; both stop on the shorter share
    (``infeed.synchronized``), so at most the odd partition of the
    re-feed is drained untrained, as a fresh job over the re-fed
    partitions would drop it.  Before the deal, partition i went to
    rank i % 2: rank 0 had pulled partitions 6, 8 and 10 ahead of the
    step that rank 1 never joined, so the re-feed was 7, 9 and 11, all
    rank 1's, and epoch 1 took no step (ROADMAP.md queue 3).  The kill's
    timing decides the counts; the test holds the bound."""
    from tensorflowonspark_tpu_torch.utils import telemetry

    monkeypatch.setenv(telemetry.DIR_ENV, str(tmp_path / "telemetry"))
    tokens = np.random.default_rng(14).integers(
        0, TINY["vocab_size"], (PARTS2 * PART_ROWS, TINY["max_seq"])
    ).astype(np.int32)
    index = row_index(tokens)
    engine = kill_engine("feed.put:kill@4")
    try:
        c = TFCluster.run(engine, transformer_spark.main_fun,
                          _heal_args(tmp_path, 2 * PART_ROWS),
                          num_executors=2,
                          input_mode=TFCluster.InputMode.SPARK,
                          reservation_timeout=TIMEOUT, restarts=1)
        c.train(engine.parallelize(list(tokens), PARTS2),
                feed_timeout=TIMEOUT)
        assert c._restarts_used == 1 and c.meta["epoch"] == 1
        assert c.server.fed_partitions("input") == list(range(PARTS2))
        c.shutdown()
    finally:
        engine.stop()
    skipped = {e["attrs"]["part"]
               for e in _events(tmp_path, "feed/partition_skipped")}
    refed = sorted(set(range(PARTS2)) - skipped)
    share = [refed[r::2] for r in (0, 1)]
    ranks = []
    for r in (0, 1):
        with open(tmp_path / f"transformer-rank{r}.json") as f:
            ranks.append(json.load(f))
    assert [r["records"] for r in ranks] == [PART_ROWS * len(s)
                                             for s in share]
    logs = [steps_log(str(tmp_path), e) for e in (0, 1)]
    starts = [[r for r in log if r["event"] == "start"] for log in logs]
    assert [[r["epoch"] for r in s] for s in starts] == [[0, 1], [0, 1]]
    resumed = starts[0][1]["resumed_step"]
    assert starts[1][1]["resumed_step"] == resumed
    e1 = [[r for r in log if r["event"] == "step" and r["epoch"] == 1]
          for log in logs]
    assert len(e1[0]) == len(e1[1]) == min(len(s) for s in share)
    assert [len(r["losses"]) for r in ranks] == [len(e1[0])] * 2
    trained = [index[tuple(k)] for log in logs for r in log
               if r["event"] == "step"
               and (r["epoch"] == 1 or r["step"] <= resumed)
               for k in r["rows"]]
    assert len(trained) == len(set(trained))  # no row trained twice
    # epoch 1 trains re-fed partitions only; the rest of them is drained
    e1_parts = {index[tuple(k)] // PART_ROWS
                for steps in e1 for r in steps for k in r["rows"]}
    assert e1_parts <= set(refed)
    drained = set(refed) - e1_parts
    assert len(drained) <= len(refed) % 2
    lost = skipped - {i // PART_ROWS for i in trained}
    print(f"re-fed {share}, epoch-1 steps {len(e1[0])}, drained "
          f"{sorted(drained)}, lost after the checkpoint {sorted(lost)}, "
          f"rows trained {len(trained)} of {len(tokens)}")
