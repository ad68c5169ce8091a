"""PyTorch port, the actor workloads (``workloads/``) on the CPU, held
against the JAX package:

- ``EvalSidecar`` evaluates each checkpoint step exactly once across a
  SIGKILL of its executor (the JAX ``tests/test_actors.py::
  test_eval_sidecar_exactly_once_across_sigkill``, the same
  assertions), and evaluates the same steps with the same results as
  the JAX sidecar over the same npz checkpoints;
- ``successive_halving`` gives the JAX function's history and best,
  also when it stops early at ``target`` (the JAX
  ``test_successive_halving_sweep`` and ``_target_early_stop``);
- like the JAX modules, ``workloads/`` carries no supervision code (the
  JAX lint, ``test_workloads_carry_zero_supervision_code``, on the
  port's files, the deploy loop's included), and the deploy loop's four
  names exist as in the JAX package, with ``deploy_table()`` listing a
  live loop (``tests/test_torch_deploy.py`` holds the loop itself).

Each ActorSystem runs on its own engine with the JAX tests' fast
liveness policy; every wait is bounded.  The ``eval_fn`` and
``trial_fn`` are module-level functions of this file, which the members
import (plain pickle), so it imports no JAX at the top.
"""

import os
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch import workloads  # noqa: E402
from tensorflowonspark_tpu_torch.actors import (  # noqa: E402
    ActorSystem,
    SupervisionPolicy,
)
from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tensorflowonspark_tpu_torch")
FAST = dict(heartbeat_secs=0.2, stale_secs=5.0, tick_secs=0.1)
ENV = {"OMP_NUM_THREADS": "1"}
WAIT = 90  # seconds a sidecar may take to see a checkpoint


def wsum_eval(tree, step):
    """The JAX test's ``eval_fn``."""
    return {"wsum": float(np.sum(tree["w"])), "step": step}


def trial_score(config, budget):
    """Deterministic: a higher config and budget score higher."""
    return config * 10 + budget


def _wait_evaluated(group, steps, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if group.ask("evaluated").result(10) == steps:
                return
        except Exception:  # noqa: BLE001 - a member between incarnations
            pass
        time.sleep(0.2)
    pytest.fail(f"steps {steps} not evaluated in {timeout} s")


def test_eval_sidecar_exactly_once_across_sigkill(tmp_path):
    ckpt_dir = str(tmp_path / "ckpts")
    os.makedirs(ckpt_dir)
    with ActorSystem(1, env=ENV) as system:
        g = system.spawn(workloads.EvalSidecar(ckpt_dir, wsum_eval), "eval",
                         policy=SupervisionPolicy(**FAST))
        ckpt.save_checkpoint(ckpt_dir, {"w": np.ones(4)}, step=1)
        _wait_evaluated(g, [1])
        latest = g.ask("latest").result(30)
        assert latest["step"] == 1 and latest["metrics"]["wsum"] == 4.0
        # SIGKILL the sidecar: the runtime respawns it, and the ledger in
        # the driver's KV makes step 1 a skip at the respawn's first poll
        os.kill(g.pids()[0], signal.SIGKILL)
        ckpt.save_checkpoint(ckpt_dir, {"w": 2 * np.ones(4)}, step=2)
        _wait_evaluated(g, [1, 2])
        assert g.respawns_observed >= 1
        # one eval/result event a step across both incarnations
        steps = [p["step"] for _i, kind, p in g.events
                 if kind == "eval/result"]
        assert steps.count(1) == 1 and steps.count(2) == 1


def test_eval_sidecar_matches_jax_over_the_same_checkpoints(tmp_path):
    """Both packages' sidecars watch one directory of npz checkpoints,
    saved one at a time: the same steps evaluated, each once, with the
    same results, in the same order."""
    from tensorflowonspark_tpu.actors import ActorSystem as JaxSystem
    from tensorflowonspark_tpu.actors import SupervisionPolicy as JaxPolicy
    from tensorflowonspark_tpu.workloads.eval_sidecar import (
        EvalSidecar as JaxSidecar,
    )

    ckpt_dir = str(tmp_path / "ckpts")
    os.makedirs(ckpt_dir)
    rng = np.random.default_rng(0)
    with ActorSystem(1, env=ENV) as ours, JaxSystem(1) as theirs:
        groups = [
            ours.spawn(workloads.EvalSidecar(ckpt_dir, wsum_eval), "eval",
                       policy=SupervisionPolicy(**FAST)),
            theirs.spawn(JaxSidecar(ckpt_dir, wsum_eval), "eval",
                         policy=JaxPolicy(**FAST))]
        for step in (3, 7, 8):
            ckpt.save_checkpoint(
                ckpt_dir, {"w": rng.standard_normal(5).astype(np.float32)},
                step=step)
            for g in groups:
                _wait_evaluated(g, sorted({3, 7, 8} & set(range(step + 1))))
        got, want = ([p for _i, kind, p in g.events if kind == "eval/result"]
                     for g in groups)
        assert [g.ask("evaluated").result(30) for g in groups] == \
            [[3, 7, 8]] * 2
        assert got == want and [p["step"] for p in got] == [3, 7, 8]
        assert [g.ask("latest").result(30) for g in groups] == [got[-1]] * 2


@pytest.mark.parametrize("target", [None, 41.0])
def test_successive_halving_matches_jax(target):
    """The port's sweep against the JAX function over the same trials:
    4 configs at budget 1, eta 2, 2 workers; rungs 4 -> 2 -> 1 at
    budgets 1, 2, 4, or one rung when config 4 reaches the target."""
    from tensorflowonspark_tpu.actors import SupervisionPolicy as JaxPolicy
    from tensorflowonspark_tpu.workloads.sweep import (
        successive_halving as jax_sweep,
    )

    got = workloads.successive_halving(
        trial_score, [1, 2, 3, 4], budget=1, eta=2, workers=2,
        policy=SupervisionPolicy(**FAST), env=ENV, target=target,
        timeout=120.0)
    want = jax_sweep(trial_score, [1, 2, 3, 4], budget=1, eta=2, workers=2,
                     policy=JaxPolicy(**FAST), target=target, timeout=120.0)
    assert got == want
    assert got["best"]["config"] == 4
    if target is None:
        assert [len(r["scores"]) for r in got["history"]] == [4, 2, 1]
        assert [r["budget"] for r in got["history"]] == [1, 2, 4]
        assert got["best"]["budget"] == 4
    else:
        assert len(got["history"]) == 1


def _code_tokens(path):
    """Source tokens without comments and string literals, joined by
    spaces (a docstring's words must not trip the lint)."""
    import tokenize

    with open(path, "rb") as f:
        return " ".join(
            t.string for t in tokenize.tokenize(f.readline)
            if t.type not in (tokenize.COMMENT, tokenize.STRING,
                              tokenize.ENCODING, tokenize.NEWLINE,
                              tokenize.NL, tokenize.INDENT,
                              tokenize.DEDENT))


def test_workloads_carry_zero_supervision_code():
    """The eval sidecar and the sweep are behaviour alone: no threads,
    signals, kills, respawns or ledgers of their own (the runtime
    provides them), as the JAX lint holds its workloads."""
    import re

    forbidden = re.compile(
        r"\b(threading|signal|kill|SIGKILL|setdefault|respawn\w*|"
        r"heartbeat\w*|_beat\w*|Lock)\b")
    wdir = os.path.join(PKG, "workloads")
    offenders = []
    names = sorted(n for n in os.listdir(wdir) if n.endswith(".py"))
    assert names == ["__init__.py", "deploy_loop.py", "eval_sidecar.py",
                     "sweep.py"], names
    for name in names:
        hits = sorted(set(forbidden.findall(
            _code_tokens(os.path.join(wdir, name)))))
        if hits:
            offenders.append(f"workloads/{name}: {hits}")
    assert not offenders, (
        "workloads must contain zero supervision code:\n  "
        + "\n  ".join(offenders))


class _PinnedPool:
    """Just the watermark surface a deploy loop's status reads."""

    def __init__(self, wm):
        self.wm = wm

    def watermark(self):
        return self.wm

    def canary(self):
        return None

    def canary_stats(self):
        return {}


@pytest.mark.parametrize("name", ["DeployLoop", "PromotionController",
                                  "deploy_table", "run_deploy_loop"])
def test_deploy_loop_names_raise_naming_their_item(name, tmp_path):
    """The four names exist in both packages, and ``deploy_table()``
    lists a live loop with the row the JAX table gives for it (the JAX
    ``tests/test_deploy.py::test_deploy_table_reports_live_loops``)."""
    import tensorflowonspark_tpu.workloads as jax_workloads

    assert hasattr(jax_workloads, name) and callable(getattr(workloads,
                                                             name))
    d = str(tmp_path / f"ckpt-{name}")
    rows = []
    for mod in (workloads, jax_workloads):
        loop = mod.DeployLoop(_PinnedPool(3), d, pct=50)
        rows.append([r for r in mod.deploy_table() if r["ckpt_dir"] == d])
        del loop
    assert rows[0] == rows[1]
    assert len(rows[0]) == 1 and rows[0][0]["watermark"] == 3
    assert rows[0][0]["state"] == "idle" and rows[0][0]["promotions"] == 0
