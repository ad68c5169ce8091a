"""The window's cut and the percentiles over every request."""

import math

import pytest

from portbench import readers
from portbench.drivers import serve_open, spark_train
from portbench.tests import tiny


def test_train_window_closes_at_the_first_step_past_its_length():
    ends = [0.0, 1.0, 1.5, 2.0, 2.7, 3.4, 4.1, 4.8, 5.5]
    last, steps, length = spark_train.window(ends, 4, 2.0)
    # opens at step 4's end (2.0); step 7 ends at 4.1, the first >= 4.0
    assert (last, steps) == (6, 3)
    assert length == pytest.approx(2.1)
    with pytest.raises(RuntimeError):
        spark_train.window(ends, 4, 10.0)


def test_rate_is_every_step_over_the_whole_window():
    run = {"window_s": 2.1, "train": {"item": "tokens", "items": 3 * 4096}}
    assert readers.train_rate(run, "tokens") == pytest.approx(12288 / 2.1)
    assert readers.train_rate(run, "images") is None


def test_nearest_rank_percentile_counts_failures_as_late():
    vals = list(range(1, 101))
    assert readers._pct(vals, 0.95) == 95
    assert readers._pct([5.0], 0.95) == 5.0
    assert readers._pct(vals[:95] + [math.inf] * 5, 0.95) == 95
    assert readers._pct(vals[:94] + [math.inf] * 6, 0.95) == math.inf


def test_serve_tally_cuts_at_the_window():
    cfg = tiny.LM
    reqs = [
        # sent before the window, first token inside it
        {"t_submit": 0.5, "times": [1.2, 1.3, 1.5], "error": None,
         "prompt": [1] * 10},
        # sent inside, finished after the window closed
        {"t_submit": 1.5, "times": [1.7, 2.4], "error": None,
         "prompt": [1] * 20},
        # sent inside, failed
        {"t_submit": 1.6, "times": [], "error": "x", "prompt": [1] * 5},
        # all before the window
        {"t_submit": 0.1, "times": [0.2, 0.3], "error": None,
         "prompt": [1] * 5},
    ]
    t = serve_open.tally(reqs, 1.0, 2.0, cfg)
    assert t["tokens"] == 4
    assert t["attempted"] == 2 and t["failed"] == 1
    assert sorted(t["ttft_ms"]) == pytest.approx([200.0, 700.0, math.inf])
    assert sorted(t["itl_ms"]) == pytest.approx([100.0, 200.0])
    assert readers.ttft_p95_ms({"serve": t}) == math.inf
