"""PyTorch port, the actor runtime (``actors/runtime.py``,
``mailbox.py``, ``policy.py``) and the ledger pieces the data service
takes from ``actors/ledger.py``, on the CPU, held against the JAX
package.

The policy's env parsing, the mailbox names and its backpressure, the
KV ledger and the resume cursor must equal the JAX package's exactly.
An ``ActorSystem`` on its own 2-executor engine spawns, asks and tells
its members, refuses a send past a full mailbox (``MailboxFull``), and
brings a SIGKILLed member back under its ``SupervisionPolicy`` (a new
epoch, the dead incarnation's ask answered once by the respawn); the
driver's ``/statusz`` lists the members.  The liveness intervals come
from the env (``TFOS_ACTOR_HEARTBEAT_*``, ``TFOS_ACTOR_TICK_SECS``), as
in the JAX package's tests, so the bounds hold on a loaded machine.
"""

import os
import queue
import secrets
import time

import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu import manager as jmanager  # noqa: E402
from tensorflowonspark_tpu.actors import ledger as jledger  # noqa: E402
from tensorflowonspark_tpu.actors import mailbox as jmailbox  # noqa: E402
from tensorflowonspark_tpu.actors import policy as jpolicy  # noqa: E402
from tensorflowonspark_tpu_torch import manager  # noqa: E402
from tensorflowonspark_tpu_torch.actors import (  # noqa: E402
    ActorSystem,
    EchoActor,
    MailboxFull,
    SupervisionPolicy,
    actor_table,
)
from tensorflowonspark_tpu_torch.actors import ledger, mailbox  # noqa: E402
from tensorflowonspark_tpu_torch.actors import policy  # noqa: E402
from tensorflowonspark_tpu_torch.obs import http as obs_http  # noqa: E402

POLICY_ENV = ("TFOS_ACTOR_HEARTBEAT_SECS", "TFOS_HEARTBEAT_SECS",
              "TFOS_ACTOR_HEARTBEAT_STALE", "TFOS_HEARTBEAT_STALE",
              "TFOS_ACTOR_RESPAWNS", "TFOS_EXECUTOR_RESPAWNS",
              "TFOS_ACTOR_RETRIES", "TFOS_TASK_RETRIES",
              "TFOS_ACTOR_BACKOFF", "TFOS_RETRY_BACKOFF",
              "TFOS_ACTOR_MAILBOX_DEPTH", "TFOS_ACTOR_TICK_SECS")


@pytest.mark.parametrize("env", [
    {},
    {"TFOS_HEARTBEAT_SECS": "0.5", "TFOS_HEARTBEAT_STALE": "7",
     "TFOS_EXECUTOR_RESPAWNS": "3", "TFOS_TASK_RETRIES": "5",
     "TFOS_RETRY_BACKOFF": "0.1"},
    {"TFOS_ACTOR_HEARTBEAT_SECS": "0.25", "TFOS_HEARTBEAT_SECS": "9",
     "TFOS_ACTOR_HEARTBEAT_STALE": "3", "TFOS_ACTOR_RESPAWNS": "1",
     "TFOS_ACTOR_RETRIES": "0", "TFOS_ACTOR_BACKOFF": "2",
     "TFOS_ACTOR_MAILBOX_DEPTH": "4", "TFOS_ACTOR_TICK_SECS": "0.05",
     "TFOS_EXECUTOR_RESPAWNS": ""},
])
def test_policy_env_parsing_matches_jax(env, monkeypatch):
    """Every knob of the env family and its aliases (an empty value is
    unset) resolves as in the JAX package; so do the managers'
    heartbeat cadence and staleness, and explicit arguments win."""
    for k in POLICY_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = SupervisionPolicy(), jpolicy.SupervisionPolicy()
    assert got.__slots__ == want.__slots__
    assert [getattr(got, k) for k in got.__slots__] == \
        [getattr(want, k) for k in want.__slots__]
    assert manager.heartbeat_interval() == jmanager.heartbeat_interval()
    assert manager.stale_after() == jmanager.stale_after()
    assert policy.env_int(3, "TFOS_NOT_SET_ANYWHERE") == \
        jpolicy.env_int(3, "TFOS_NOT_SET_ANYWHERE")
    p = SupervisionPolicy(respawns=0, stale_secs=1.5, tick_secs=0.1,
                          epoch_fencing=False)
    assert (p.respawns, p.stale_secs, p.tick_secs, p.epoch_fencing) == \
        (0, 1.5, 0.1, False)


def test_mailbox_names_and_backpressure_match_jax():
    for fn in ("in_queue", "beat_key", "epoch_key"):
        assert getattr(mailbox, fn)("g", 3) == getattr(jmailbox, fn)("g", 3)
    assert mailbox.out_queue("g") == jmailbox.out_queue("g")
    q, jq = queue.Queue(), queue.Queue()
    assert mailbox.checked_put(q, "m", ("tell",), 2) == \
        jmailbox.checked_put(jq, "m", ("tell",), 2) == 1
    assert mailbox.checked_put(q, "m", ("tell",), 2) == 2
    with pytest.raises(MailboxFull) as e:
        mailbox.checked_put(q, "m", ("tell",), 2)
    with pytest.raises(jmailbox.MailboxFull) as je:
        jmailbox.checked_put(jq, "m", ("tell",), 1)
    assert (e.value.depth, e.value.limit) == (2, 2)
    assert str(je.value).split(" (")[0] == str(e.value).split(" (")[0]
    assert mailbox.checked_put(q, "m", ("tell",), 0) == 3  # 0: unbounded


def _kv_ledger(mgr_mod, led_mod):
    m = mgr_mod.start(secrets.token_bytes(8), [])
    try:
        led = led_mod.KVLedger(m, "grp")
        out = [led.record("f", 2), led.record("f", 2), led.record("f", 0),
               led.record("g", 5), led.done("f", 2), led.done("f", 1),
               led.done_units("f"), led.done_units("g")]
    finally:
        m.shutdown()
    null = led_mod.NullLedgerClient()
    null.partition_done("f", 1)
    null.close()
    return out + [null.fed_partitions("f"),
                  led_mod.resume_cursor([0, 1, 2, 4], 0),
                  led_mod.resume_cursor([0, 1, 2, 4], 3),
                  led_mod.resume_cursor((), 7)]


def test_kv_ledger_and_resume_cursor_match_jax():
    got = _kv_ledger(manager, ledger)
    assert got == _kv_ledger(jmanager, jledger)
    assert got[6] == [0, 2] and got[-3:] == [3, 3, 7]


@pytest.fixture(scope="module")
def system():
    """A 2-slot system on its own engine; ticks, beats and the stale
    bound from the env its executors inherit."""
    keys = {"TFOS_ACTOR_HEARTBEAT_SECS": "0.2",
            "TFOS_ACTOR_HEARTBEAT_STALE": "5",
            "TFOS_ACTOR_TICK_SECS": "0.1", "OMP_NUM_THREADS": "1"}
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    try:
        s = ActorSystem(capacity=3, env=keys)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    yield s
    s.stop()


def test_spawn_ask_tell_and_statusz(system):
    """Two members answer asks (each its own pid), a tell reaches the
    least loaded, idle members tick, and the driver's ``/statusz``
    lists both, live, at epoch 0; a group name is taken once, a spawn
    past the free slots is refused, and a handler's error reaches the
    asker while its member serves on."""
    g = system.spawn(EchoActor(), "echo", count=2,
                     policy=SupervisionPolicy(heartbeat_secs=0.2,
                                              tick_secs=0.1), timeout=120)
    pids = {g.ask("pid", index=i).result(60) for i in range(2)}
    assert len(pids) == 2 and pids == set(g.pids().values())
    assert g.ask("echo-me", {"a": [1, 2]}).result(60) == {"a": [1, 2]}
    assert g.tell("noted", 1) in (0, 1)
    assert sorted(g.broadcast("noted", 2)) == [0, 1]
    time.sleep(0.5)   # idle: five ticks' worth
    assert g.ask("ticks", index=0).result(60) > 0
    rows = [r for r in actor_table() if r["group"] == "echo"]
    assert [(r["actor"], r["live"], r["epoch"]) for r in rows] == \
        [(0, True, 0), (1, True, 0)]
    status = obs_http.ObsServer(None, port=0).render_statusz()
    assert [r["actor"] for r in status["actors"]
            if r["group"] == "echo"] == [0, 1]
    with pytest.raises(ValueError, match="already exists"):
        system.spawn(EchoActor(), "echo")
    with pytest.raises(ValueError, match="slots free"):
        system.spawn(EchoActor(), "more", count=2)
    # a handler that raises: the asker gets the traceback, the member
    # keeps serving
    with pytest.raises(RuntimeError, match="failed 'sleep'"):
        g.ask("sleep", "not a number", index=1).result(60)
    assert g.ask("pid", index=1).result(60) == g.pids()[1]


def _when_room(send, *args, timeout=30):
    """``send(*args)``, retried while the mailbox is full."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return send(*args)
        except MailboxFull:
            assert time.monotonic() < deadline, "the mailbox never drained"
            time.sleep(0.05)


def test_mailbox_full_then_respawn_after_a_kill(system):
    """A member busy in a 2 s ask holds a mailbox of depth 1: the next
    send raises ``MailboxFull``.  Then ``crash`` SIGKILLs the member: the
    engine respawns its slot, the group sees the respawn, bumps its
    epoch (fencing the dead incarnation's mail) and re-sends its open
    ask, which the new incarnation answers once."""
    g = system.spawn(EchoActor(), "fragile", count=1,
                     policy=SupervisionPolicy(heartbeat_secs=0.2,
                                              tick_secs=0.1,
                                              mailbox_depth=1, respawns=2),
                     timeout=120)
    pid0 = g.ask("pid").result(60)
    busy = g.ask("sleep", 2.0)
    with pytest.raises(MailboxFull):
        for _ in range(50):
            g.tell("noted", 0)
    assert busy.result(60) == 2.0
    # a mailbox of depth 1 may still hold the message before (the one
    # "noted" that got in, "crash", the fenced copy of a re-sent ask)
    # when the next send comes: each retries, as a sender told
    # MailboxFull does
    _when_room(g.tell, "crash")
    pending = _when_room(g.ask, "echo", "after the kill")
    assert pending.result(120) == "after the kill"
    pid1 = _when_room(g.ask, "pid").result(60)
    assert pid1 != pid0
    assert g.respawns_observed == 1 and g.epochs()[0] >= 1
    assert g.outstanding() == 0


class _DieOnce:
    """An engine task that SIGKILLs its executor on its first run (a
    marker file says it ran) and returns its executor's pid after."""

    def __init__(self, marker):
        self.marker = marker

    def __call__(self, it):
        list(it)
        if not os.path.exists(self.marker):
            open(self.marker, "w").close()
            os.kill(os.getpid(), 9)
        return [os.getpid()]


def test_a_task_lost_to_another_jobs_respawn_is_retried(tmp_path):
    """Two groups' jobs share an engine, so one job's loop may respawn an
    executor that ran the other's task (here the test's thread does, as
    soon as the executor dies): the other job still counts its task
    lost and runs it again on the respawn, instead of waiting for an
    answer that never comes."""
    import threading

    from tensorflowonspark_tpu_torch.engine import LocalEngine

    engine = LocalEngine(1, env={"OMP_NUM_THREADS": "1"})
    try:
        pid0 = engine._procs[0].pid
        out = {}

        def job():
            out["pids"] = engine.parallelize([0], 1).map_partitions(
                _DieOnce(str(tmp_path / "ran"))).collect(
                    placement=[0], retryable=True, max_retries=2)

        t = threading.Thread(target=job, daemon=True)
        t.start()
        deadline = time.monotonic() + 60
        while engine._procs[0].is_alive() and time.monotonic() < deadline:
            time.sleep(0.001)
        engine._respawn_executor(0)   # another job's loop wins the race
        t.join(60)
        assert not t.is_alive(), "the job never learned its task was lost"
        assert out["pids"] == [engine._procs[0].pid] and \
            out["pids"][0] != pid0
    finally:
        engine.stop()
