"""Tiny CPU rehearsals of each driver's control flow, and runs with the
timed path broken underneath, which must come out not correct."""

import itertools

import pytest

from portbench import harness
from portbench.tests import tiny

SEED = 2_147_483_911  # above 2**31, as the driver's are


def _run(cell, seconds=2, trace=False, **kw):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            overrides=tiny.overrides(cell, **kw))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_rehearsal(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    e2e = {m["name"] for m in harness.metrics_for(
        harness.json.loads((harness.ROOT / "BENCHMARK.json").read_text()),
        cell)[0]}
    assert set(out["metrics"]) == e2e
    assert "setup_s" in out["metrics"]
    assert out["checks"]["leftovers"]["value"] == 0


def test_rehearsal_traced_reads_the_per_layer_metrics():
    out = _run("pythia-2.8b.train.spark", trace=True)
    assert out["correct"], out["checks"]
    for name in ("boot_s.train", "device_step_ms.train_lm",
                 "mfu.train_lm", "feed_wait_frac.train_lm"):
        assert name in out["metrics"], out["metrics"]
    assert "breakdown" in out and "window_s" in out["device"]


@pytest.mark.parametrize("cell,fault", [
    ("pythia-2.8b.train.spark", "unchanged_lm"),
    ("pythia-2.8b.train.spark", "half_lm"),
    ("resnet-50.train.tfrecord", "unchanged_resnet"),
    ("resnet-50.train.tfrecord", "half_resnet"),
])
def test_broken_step_is_not_correct(cell, fault):
    out = _run(cell, main_fun=f"portbench.tests.faults:{fault}")
    assert not out["correct"], out["checks"]
    assert out["checks"]["feed_mismatch"]["value"] == 0


def test_altered_token_is_not_correct(monkeypatch):
    from tensorflowonspark_tpu_torch.serving.decode import scheduler

    real = scheduler._sampling.sample_token
    calls = itertools.count()

    def altered(logits, params, index):
        tok = real(logits, params, index)
        return (tok + 1) % 256 if next(calls) % 5 == 3 else tok

    monkeypatch.setattr(scheduler._sampling, "sample_token", altered)
    out = _run("pythia-2.8b.serve.chat")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["pythia-2.8b.train.spark",
                                  "resnet-50.train.tfrecord",
                                  "pythia-2.8b.serve.chat"])
def test_control_fails_a_limit(cell):
    """The reference in float8 in the program's place fails one of the
    cell's numbers, where the program passes them all."""
    out = harness.run_cell(cell, SEED, 2, False, device="cpu",
                           overrides=tiny.overrides(cell), controls=True)
    assert out["correct"], out["checks"]
    limits = tiny.overrides(cell)["cell"]["limits"]
    ctl = out["controls"]["control_float8"]
    assert any(ctl[k] > lim for k, lim in limits.items() if k in ctl), ctl
