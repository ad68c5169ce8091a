"""PyTorch port, the bring-up health check (``gpu_info.slice_health``,
``TFNodeContext.torch_initialize``) against the JAX package's
(``tpu_info.slice_health``, ``TFNodeContext.jax_initialize``), on the
CPU: each case of ``tests/test_tpu_info.py``'s slice-health tests as a
port test, the two packages' bring-up decisions under every
``TFOS_SLICE_HEALTH`` mode on the same reports, their report keys, and
the cross-process device count on two gloo ranks, which meets in a
``TCPStore``.

A probe stubbed to hang waits on an ``Event`` that the test sets after
its assertions, so that no probe thread outlives the file.
"""

import datetime
import threading
import time

import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402,F401

from tensorflowonspark_tpu import node as JN  # noqa: E402
from tensorflowonspark_tpu import tpu_info  # noqa: E402
from tensorflowonspark_tpu_torch import gpu_info, node  # noqa: E402
from tensorflowonspark_tpu_torch.parallel.launch import (  # noqa: E402
    RankPool,
    free_port,
)

PROBE = "tfos-slice-health"  # the probe thread's name
SILENT_TIMEOUT_S = 0.5


def _port_ctx():
    """A one-process job's context (no manager, no group)."""
    info = [{"executor_id": 0, "host": "127.0.0.1", "job_name": "worker",
             "task_index": 0, "port": 1}]
    return node.TFNodeContext(0, "worker", 0, {"worker": info}, "file://",
                              "/tmp", None, cluster_info=info)


def _jax_ctx(monkeypatch):
    ctx = JN.TFNodeContext.__new__(JN.TFNodeContext)
    monkeypatch.setattr(
        JN.TFNodeContext, "distributed_env",
        lambda self: {"num_processes": 1, "process_id": 0,
                      "coordinator_address": "127.0.0.1:1"})
    return ctx


def _report(errors, timed_out=False, bare_timeout=False):
    return {"healthy": not errors, "platform": "cpu", "kind": "cpu",
            "local_devices": 1, "global_devices": 1, "process_index": 0,
            "timed_out": timed_out, "bare_timeout": bare_timeout,
            "errors": list(errors), "probe_s": 0.0}


def _join_probes(timeout=10.0):
    """Wait for every probe thread of this process to end."""
    for t in threading.enumerate():
        if t.name == PROBE:
            t.join(timeout)
            assert not t.is_alive()


# -- the seven cases of the JAX package's tests ------------------------------

def test_slice_health_on_the_cpu():
    """Healthy on the CPU with the expected counts (one process, one
    device); expectation mismatches are reported without raising, with
    the JAX package's process-count text."""
    h = gpu_info.slice_health(expected_processes=1,
                              expected_local_devices=1, device="cpu")
    assert h["healthy"], h
    assert h["local_devices"] == 1 and h["global_devices"] == 1
    assert h["platform"] == "cpu" and h["kind"] == "cpu"
    assert h["process_index"] == 0 and h["probe_s"] >= 0

    sick = gpu_info.slice_health(expected_processes=2,
                                 expected_local_devices=4, device="cpu")
    assert not sick["healthy"] and not sick["timed_out"]
    assert any("local devices" in e for e in sick["errors"])
    want = [e for e in tpu_info.slice_health(expected_processes=2)["errors"]
            if e.startswith("process count")]
    assert want == [e for e in sick["errors"]
                    if e.startswith("process count")] == \
        ["process count 1 != expected 2"]


def test_unhealthy_slice_is_fatal_at_bring_up(monkeypatch):
    """torch_initialize raises on an unhealthy report (the node wrapper
    carries it to the error queue), unless TFOS_SLICE_HEALTH=warn, when
    the report is returned under the JAX name."""
    sick = _report(["device cpu smoke product returned [[0.0]]"])
    monkeypatch.setattr(gpu_info, "slice_health", lambda **kw: sick)
    monkeypatch.delenv(node.HEALTH_MODE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="unhealthy accelerator slice"):
        _port_ctx().torch_initialize("cpu")
    monkeypatch.setenv(node.HEALTH_MODE_ENV, "warn")
    env = _port_ctx().torch_initialize("cpu")
    assert env["slice_health"] is sick and "health" not in env


@pytest.mark.parametrize("value,want", [
    ("2.5", 2.5), ("nan", 60.0), ("0", 60.0), ("-3", 60.0), ("soon", 60.0),
    ("inf", float("inf"))])
def test_slice_health_timeout_env_parse(monkeypatch, value, want):
    """TFOS_SLICE_HEALTH_TIMEOUT as the JAX package reads it: nan, 0,
    negatives and garbage fall back to 60 (inf is capped at the join's
    limit by slice_health)."""
    monkeypatch.setenv(gpu_info.HEALTH_TIMEOUT_ENV, value)
    assert gpu_info._health_timeout() == want


def test_slice_health_timeout_env_and_snapshot(monkeypatch):
    """The probe's window comes from TFOS_SLICE_HEALTH_TIMEOUT, a hung
    probe sets ``timed_out`` within it, and the returned dict is a
    snapshot that the probe, finishing later, cannot change."""
    release = threading.Event()
    real = gpu_info._local_devices

    def slow_local_devices(*args):
        release.wait(30)
        return real(*args)

    monkeypatch.setattr(gpu_info, "_local_devices", slow_local_devices)
    monkeypatch.setenv(gpu_info.HEALTH_TIMEOUT_ENV, "0.2")
    t0 = time.monotonic()
    h = gpu_info.slice_health(expected_processes=1, device="cpu")
    waited = time.monotonic() - t0
    try:
        assert h["timed_out"] and h["bare_timeout"] and not h["healthy"]
        assert 0.2 <= waited < 1.2, waited
        assert any(gpu_info.HEALTH_TIMEOUT_ENV in e for e in h["errors"])
        n_errors = len(h["errors"])
    finally:
        release.set()
        _join_probes()
    assert len(h["errors"]) == n_errors and "done" not in h
    assert h["local_devices"] == 0 and h["probe_s"] is None


def test_probe_timeout_is_warn_only_at_bring_up(monkeypatch):
    """Under the default lenient mode a probe that merely timed out does
    not fail bring-up."""
    slow = _report(["health probe still hung after 0.2s"], timed_out=True,
                   bare_timeout=True)
    monkeypatch.setattr(gpu_info, "slice_health", lambda **kw: slow)
    monkeypatch.delenv(node.HEALTH_MODE_ENV, raising=False)
    env = _port_ctx().torch_initialize("cpu")
    assert env["slice_health"] is slow


def test_probe_timeout_fatal_in_strict_mode(monkeypatch):
    """TFOS_SLICE_HEALTH=strict makes a bare timeout fatal too."""
    slow = _report(["health probe still hung after 0.2s"], timed_out=True,
                   bare_timeout=True)
    monkeypatch.setattr(gpu_info, "slice_health", lambda **kw: slow)
    monkeypatch.setenv(node.HEALTH_MODE_ENV, "strict")
    with pytest.raises(RuntimeError, match="unhealthy accelerator slice"):
        _port_ctx().torch_initialize("cpu")


def test_definite_errors_survive_a_hung_probe(monkeypatch):
    """A finding made before the probe hangs (here in the smoke product)
    is in the timeout's snapshot, so a definitely broken job is never
    taken for a bare timeout."""
    release = threading.Event()

    def hung_product(dev):
        release.wait(30)

    monkeypatch.setattr(gpu_info, "_smoke_product", hung_product)
    monkeypatch.setenv(gpu_info.HEALTH_TIMEOUT_ENV, "0.4")
    try:
        h = gpu_info.slice_health(expected_processes=7, device="cpu")
        assert h["timed_out"] and not h["bare_timeout"]
        assert any("process count" in e for e in h["errors"]), h["errors"]
        assert len(h["errors"]) >= 2  # the finding and the timeout's
    finally:
        release.set()
        _join_probes()


def test_slice_health_flags_gpus_cuda_does_not_see(monkeypatch):
    """GPUs on the host and no CUDA device, for a caller that did not ask
    for the CPU, mean the CUDA runtime failed: unhealthy.  A caller that
    asked for the CPU chose it: healthy."""
    monkeypatch.setenv(gpu_info.COUNT_ENV, "4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gpu_info.slice_health(expected_processes=1,
                                 device="cpu")["healthy"]
    sick = gpu_info.slice_health(expected_processes=1)
    assert not sick["healthy"] and sick["platform"] is None
    assert any("4 GPUs present on this host but CUDA sees none" in e
               for e in sick["errors"]), sick["errors"]


def test_a_wedged_card_raises_within_the_bound(monkeypatch):
    """A card that hangs every CUDA call, the probe's first contact and
    this thread's alike: under strict, torch_initialize raises within
    the timeout plus 1 s, before this thread makes a CUDA call."""
    release = threading.Event()
    calls = []

    def wedged(*args):
        calls.append(threading.current_thread().name)
        release.wait(30)
        return []

    monkeypatch.setattr(gpu_info, "_local_devices", wedged)
    for name in ("is_available", "current_device", "device_count"):
        monkeypatch.setattr(torch.cuda, name, wedged)
    monkeypatch.setenv(node.HEALTH_MODE_ENV, "strict")
    monkeypatch.setenv(gpu_info.HEALTH_TIMEOUT_ENV, "0.3")
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="unhealthy accelerator"):
            _port_ctx().torch_initialize()
        waited = time.monotonic() - t0
        assert calls == [PROBE], calls
    finally:
        release.set()
        _join_probes()
    assert 0.3 <= waited < 1.3, waited


def test_the_probe_checks_the_ranks_own_card(monkeypatch):
    """On a host of 8 visible cards, the probe of local rank 11 counts and
    names card 3 alone (11 mod 8), as torch_initialize takes it; an
    explicit index is that card; without a rank, every visible card."""
    named = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d: named.append(d) or "stub card")
    h = gpu_info.slice_health(expected_processes=1, smoke=False,
                              local_rank=11)
    assert h["healthy"], h
    assert h["local_devices"] == 1 and h["global_devices"] == 1
    assert named == [torch.device("cuda", 3)] and h["kind"] == "stub card"
    cuda = torch.device("cuda", 5)
    assert gpu_info._local_devices(cuda, 11) == [cuda]
    assert len(gpu_info._local_devices(torch.device("cuda"))) == 8
    with pytest.raises(RuntimeError, match="but 8 visible"):
        gpu_info._local_devices(torch.device("cuda", 8))


# -- the two packages against each other ------------------------------------

REPORTS = {
    "healthy": _report([]),
    "finding": _report(["global devices 1 != expected 2"]),
    "bare_timeout": _report(["health probe still hung after 0.2s"],
                            timed_out=True, bare_timeout=True),
    "finding_and_timeout": _report(
        ["local devices 0 != expected 1",
         "health probe still hung after 0.2s"], timed_out=True),
}


@pytest.mark.parametrize("report", sorted(REPORTS))
@pytest.mark.parametrize("mode", ["strict", "lenient", "warn", "bogus"])
def test_bring_up_decides_as_the_jax_package(monkeypatch, mode, report):
    """The same report under the same TFOS_SLICE_HEALTH mode: the port's
    torch_initialize raises exactly where the JAX package's
    jax_initialize does, and otherwise returns the report."""
    health = REPORTS[report]
    monkeypatch.setenv(node.HEALTH_MODE_ENV, mode)
    monkeypatch.setattr(tpu_info, "slice_health", lambda **kw: health)
    monkeypatch.setattr(gpu_info, "slice_health", lambda **kw: health)

    def outcome(init):
        try:
            env = init()
        except RuntimeError as e:
            assert "unhealthy accelerator slice" in str(e)
            return "raised"
        assert env["slice_health"] is health
        return "proceeded"

    jax_said = outcome(_jax_ctx(monkeypatch).jax_initialize)
    port_said = outcome(lambda: _port_ctx().torch_initialize("cpu"))
    fatal = not health["healthy"] and mode != "warn" and not (
        health["bare_timeout"] and mode != "strict")
    assert port_said == jax_said == ("raised" if fatal else "proceeded")


def test_reports_have_the_jax_keys():
    """The port's report has the JAX report's keys, plus the device's
    name (``kind``) and the probe's seconds (``probe_s``)."""
    got = gpu_info.slice_health(expected_processes=1, device="cpu")
    want = tpu_info.slice_health(expected_processes=1)
    assert set(got) - {"kind", "probe_s"} == set(want)


def test_local_device_info(monkeypatch):
    """Entries with the JAX package's keys, from torch.cuda; [] without
    CUDA or on an error."""
    assert gpu_info.local_device_info() == []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    got = gpu_info.local_device_info()
    assert [d["id"] for d in got] == [0, 1]
    assert all(d["platform"] == "gpu" for d in got)
    assert set(got[0]) == set(tpu_info.local_device_info()[0])

    def broken():
        raise RuntimeError("CUDA gone")

    monkeypatch.setattr(torch.cuda, "device_count", broken)
    assert gpu_info.local_device_info() == []


# -- two gloo ranks: the device count through the store ----------------------

def _two_rank_health(port):
    """On each rank of a 2-rank gloo job: the counts through a
    ``TCPStore`` (rank 0 its server), healthy when both expect 2, rank 1
    told 3, and rank 0 alone waiting on a peer that never writes."""
    import torch.distributed as dist

    rank = dist.get_rank()
    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0,
                          timeout=datetime.timedelta(seconds=60),
                          wait_for_workers=False)

    def health(prefix, expected, timeout=30.0):
        return gpu_info.slice_health(
            expected_processes=expected, device="cpu", timeout=timeout,
            store=dist.PrefixStore(prefix, store), rank=rank,
            world_size=2)

    ok = health("ok", 2)
    told = health("told", 3 if rank == 1 else 2)
    dist.barrier()
    silent = silent_s = None
    if rank == 0:
        t0 = time.monotonic()
        silent = health("silent", 2, timeout=SILENT_TIMEOUT_S)
        silent_s = time.monotonic() - t0
    dist.barrier()  # rank 1 holds its store until rank 0 is done
    return dict(ok=ok, told=told, silent=silent, silent_s=silent_s)


def test_two_gloo_ranks_count_through_the_store():
    """Both ranks expecting 2: healthy, 2 global devices.  Rank 1 told 3
    gets the JAX package's texts; rank 0 stays healthy.  A peer that
    never writes its count: a bare timeout within the limit, no hang."""
    with RankPool(2) as pool:
        r0, r1 = pool.run(_two_rank_health, free_port(), timeout=120)
    for r in (r0, r1):
        assert r["ok"]["healthy"], r["ok"]
        assert r["ok"]["global_devices"] == 2
    assert [r0["ok"]["process_index"], r1["ok"]["process_index"]] == [0, 1]
    assert r0["told"]["healthy"], r0["told"]
    assert r1["told"]["errors"] == [
        "process count 2 != expected 3",
        "global devices 2 != expected 3 (a peer host may be short of "
        "chips)"]
    silent = r0["silent"]
    assert silent["timed_out"] and silent["bare_timeout"], silent
    assert silent["local_devices"] == 1 and silent["global_devices"] == 0
    assert SILENT_TIMEOUT_S <= r0["silent_s"] < SILENT_TIMEOUT_S + 1.0
