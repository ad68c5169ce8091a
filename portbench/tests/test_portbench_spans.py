"""The readers of the program's phases and feeder records
(``portbench/spans.py``), on hand-made runs, and on tiny traced CPU
runs of both training cells."""

import pytest

from portbench import harness, readers, spans
from portbench.tests import tiny

NEW = ("fwd_ms.train_lm", "bwd_ms.train_lm", "opt_ms.train_lm",
       "idle_wait_frac.train_lm", "idle_wait_frac.train_resnet",
       "feed_gap_ms.train_resnet")


def _run(device, waits, extent=(0.0, 100e3), steps=None):
    """A traced run: ``device`` intervals and ``waits`` (start, end) in
    us on the host's clock."""
    phases = steps or [{"step": i, "input_wait": [a / 1e6, (b - a) / 1e3]}
                       for i, (a, b) in enumerate(waits)]
    return {"trace": {"device": [["k", a, b] for a, b in device],
                      "extent_us": list(extent), "idle_gaps": []},
            "traffic": {"warm_steps": 1},
            "report": {"train_metrics": {"phases": phases}}}


def test_a_gap_inside_a_wait_counts_in_full_one_outside_not_at_all():
    # device idle over [10, 20] ms (inside the wait [5, 25]) and over
    # [60, 70] (no wait there); the wait's busy part does not count
    run = _run([(0, 10e3), (20e3, 60e3), (70e3, 100e3)], [(5e3, 25e3)])
    assert spans.idle_wait_frac(run) == pytest.approx(10.0)
    assert readers.idle_frac(run) == pytest.approx(20.0)
    # a wait over both gaps takes both; waits that overlap count once
    run = _run([(0, 10e3), (20e3, 60e3), (70e3, 100e3)],
               [(5e3, 80e3), (8e3, 22e3)])
    assert spans.idle_wait_frac(run) == pytest.approx(20.0)


@pytest.mark.parametrize("seed", range(20))
def test_idle_wait_frac_is_at_most_idle_frac(seed):
    import random

    rng = random.Random(seed)

    def intervals(n):
        out = []
        for _ in range(n):
            a = rng.uniform(-10e3, 110e3)
            out.append((a, a + rng.uniform(0, 15e3)))
        return out

    run = _run(intervals(12), intervals(6))
    # the extent covers every device stamp, as trace.compact's does
    stamps = [t for iv in run["trace"]["device"] for t in iv[1:]]
    run["trace"]["extent_us"] = [min(stamps + [0.0]),
                                 max(stamps + [100e3])]
    got = spans.idle_wait_frac(run)
    assert 0.0 <= got <= readers.idle_frac(run) + 1e-9


def test_phase_ms_takes_the_steps_from_warm_on():
    steps = [{"step": 0, "forward": 100.0, "backward": 5.0},
             {"step": 1, "forward": 3.0, "backward": 6.0},
             {"step": 2, "forward": 5.0, "backward": 7.0},
             {"step": 3, "forward": 4.0}]
    run = _run([], [], steps=steps)
    assert spans.phase_ms(run, "forward") == 4.0
    assert spans.phase_ms(run, "backward") == 6.5
    assert spans.phase_ms(run, "optimizer") is None


def _feeder(executor, part, start, drain_end, first_put):
    return {"executor": executor, "part": part,
            "partition": [start, 1e3 * (drain_end + 0.01 - start)],
            "read": [start, 1.0], "put": [[first_put, 2.0]],
            "drain": [drain_end - 0.5, 500.0]}


def test_feed_gap_ms_orders_by_executor_and_partition():
    feeders = [  # as a KV might hold them: out of order
        _feeder(1, 0, 100.0, 101.0, 100.2),
        _feeder(0, 1, 10.0, 11.0, 10.05),   # 100 ms after partition 0
        _feeder(0, 0, 8.0, 9.95, 8.1),
        _feeder(1, 1, 101.1, 102.0, 101.3),  # 300 ms after exec 1's 0
        _feeder(0, 0, 11.02, 13.0, 11.03),  # a second epoch: 30 ms
        {"executor": 0, "part": 3, "put": []},  # cut short: not read
    ]
    run = {"report": {"feeders": feeders}}
    # the median of 100, 30 and 300; in the KV's order, or with the
    # executors mixed, the gaps would be others
    assert spans.feed_gap_ms(run) == pytest.approx(100.0)
    assert spans.feed_gap_ms({"report": {"feeders": feeders[:2]}}) is None


def test_a_run_without_the_records_reads_nothing():
    """A program without phases or the feeders' parts (the parent of
    the change that added them) leaves the new metrics out."""
    old = {"trace": {"device": [["k", 0.0, 5.0]], "extent_us": [0.0, 9.0],
                     "idle_gaps": []},
           "traffic": {"warm_steps": 1},
           "report": {"train_metrics": {"steps": 3},
                      "feeders": [{"part": 0, "start_wall": 1.0,
                                   "first_put_wall": 1.1,
                                   "consumed_wall": 2.0}]}}
    for name in NEW:
        assert harness.load_module("metrics", name).read(old) is None
        assert harness.load_module("metrics", name).read({}) is None


@pytest.mark.parametrize("cell,names", [
    ("pythia-2.8b.train.spark", ("fwd_ms.train_lm", "bwd_ms.train_lm",
                                 "opt_ms.train_lm")),
    ("resnet-50.train.tfrecord", ("feed_gap_ms.train_resnet",)),
])
def test_traced_rehearsal_reads_the_new_metrics(cell, names):
    """On the CPU the trace has no device intervals, so the idle shares
    read nothing; the phases (host ms here) and the feeders do."""
    out = harness.run_cell(cell, 2_147_483_911, 2, True, device="cpu",
                           overrides=tiny.overrides(cell))
    assert out["correct"], out["checks"]
    for name in names:
        assert name in out["metrics"], out["metrics"]
        assert out["metrics"][name]["value"] >= 0.0
