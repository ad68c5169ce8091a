"""PyTorch port, the CUDA graph per bucket (``utils/cuda_graphs.py``) on
the CPU, where no graph exists: the bookkeeping around the graphs, held
against the JAX package's per-signature executables.

The tests inject a :class:`GraphCache` whose capture is a plain call
(:func:`_plain_capture`: the "graph" calls the captured function again
at each replay and writes its static outputs in place), so what they
hold is the signature logic, the static inputs and outputs, the reload
rule and the launch accounting, not the CUDA graph:

- for one sequence of batch sizes through the batcher's buckets, the
  port's ``_Predictor`` (``jit=None``) gives the JAX ``_Predictor``'s
  ``compiles``, key for key and count for count, captures once a
  signature, and its logits equal the JAX ``serve_predict``'s; an
  elastic resize's mesh shape keys new signatures, as in JAX;
- a reload with matching shapes refills the captured params in place
  (no capture, the new params' logits); one with other shapes drops the
  graphs and recaptures, one more ``compiles`` a signature;
- a graph's recorded launches count at each replay and never at its
  capture; another thread's launches during a capture count at once;
- the decode engine stepped through injected graphs gives the eager
  engine's tokens and the JAX oracle's, plain, paged with prefix hits,
  slot mode and speculative (equal accept counts), captures each bucket
  once, and a ``set_params`` refills its graphs in place;
- ``jit=True`` on the CPU raises ``ValueError`` (``ModelSpec``, the
  predictor, the engine); ``jit=False`` never captures.

Tokens compare exactly; logits to 1e-5 of the largest.
"""

import functools
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402

from tensorflowonspark_tpu import ops as jops  # noqa: E402
from tensorflowonspark_tpu.models import mnist as JM  # noqa: E402
from tensorflowonspark_tpu.models import transformer as JT  # noqa: E402
from tensorflowonspark_tpu.serving import replicas as JR  # noqa: E402
from tensorflowonspark_tpu_torch import ops, serving  # noqa: E402
from tensorflowonspark_tpu_torch.models import mnist  # noqa: E402
from tensorflowonspark_tpu_torch.models import transformer as TT  # noqa: E402
from tensorflowonspark_tpu_torch.ops import attention  # noqa: E402
from tensorflowonspark_tpu_torch.serving import batcher as B  # noqa: E402
from tensorflowonspark_tpu_torch.serving import replicas as R  # noqa: E402
from tensorflowonspark_tpu_torch.serving.decode import (  # noqa: E402
    scheduler as D,
)
from tensorflowonspark_tpu_torch.utils import cuda_graphs  # noqa: E402

HANG = 120
KW = dict(vocab_size=61, dim=32, n_layers=2, n_heads=2, max_seq=64,
          dtype="float32")
DKW = dict(KW, dim=16, n_layers=1)
RTOL = 1e-5
SIZES = [1, 3, 8, 5, 2, 16, 7, 1, 13, 4, 16, 9]   # one batcher burst each
MAX_BATCH = 16


def _flat(out):
    return list(out.values()) if isinstance(out, dict) else (
        list(out) if isinstance(out, (tuple, list)) else [out])


class _PlainGraph:
    """What ``_plain_capture`` returns: ``replay()`` calls the function
    again on the static inputs and writes the static outputs in place."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs
        self.replays = 0

    def replay(self):
        # a graph's launches count at its replay (``Graph.__call__``), not
        # where the function's wrappers run again here
        with cuda_graphs.recording_launches():
            out = self.fn(*self.inputs)
        for dst, src in zip(_flat(self.outputs), _flat(out)):
            dst.copy_(src)
        self.replays += 1


def _plain_capture(fn, inputs, pool):
    """A capture that is a plain call: the static outputs are the first
    call's, cloned; nothing is recorded."""
    del pool
    out = fn(*inputs)
    if isinstance(out, dict):
        out = {k: v.clone() for k, v in out.items()}
    elif isinstance(out, (tuple, list)):
        out = type(out)(v.clone() for v in out)
    else:
        out = out.clone()
    return _PlainGraph(fn, inputs, out), out, {}


def _cache():
    return cuda_graphs.GraphCache("cpu", capture=_plain_capture)


# -- predicts -----------------------------------------------------------------

@pytest.fixture(scope="module")
def mnist_params():
    """JAX-made MNIST params (numpy, the export's layout), and a second
    set of the same shapes."""
    return [jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(s))) for s in (0, 1)]


def _bursts(seed=0):
    """The batcher's padded bucket for each size of :data:`SIZES`."""
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        x = rng.random((n, 28, 28, 1), dtype=np.float32)
        out.append({"image": B.pad_rows(x, B.bucket_size(n, MAX_BATCH))})
    return out


def _logits_close(got, want):
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= RTOL, err


def test_predictor_signatures_match_jax(mnist_params):
    """The port's predictor with graphs (a plain-call capture) counts the
    JAX predictor's compiles, captures each signature once and replays
    it after, and serves the JAX logits; an elastic mesh shape keys new
    signatures in both."""
    pj = mnist_params[0]
    graphs = _cache()
    port = R._Predictor(mnist.predict, pj, 0, "cpu", graphs=graphs)
    ref = JR._Predictor(JM.serve_predict, pj, 0, None)
    for inputs in _bursts():
        got, _ = port(inputs)
        want, _ = ref(inputs)
        _logits_close(got["logits"], want["logits"])
        assert (got["prediction"] == want["prediction"]).all()
    assert port.compiles == ref.compiles
    n_sigs = len(ref.compiles)
    assert n_sigs <= int(np.log2(MAX_BATCH)) + 1
    assert set(port.compiles.values()) == {1}
    st = port.stats()
    assert (st["graphs"], st["eager_signatures"]) == (n_sigs, 0)
    assert graphs.captures == n_sigs
    assert sum(g.replays for g in map(graphs.get, graphs.keys())) == \
        len(SIZES)
    port.mesh_shape = ref.mesh_shape = (("data", 2),)
    for inputs in _bursts(1)[:3]:
        port(inputs)
        ref(inputs)
    assert port.compiles == ref.compiles
    assert len(port.compiles) > n_sigs and port.stats()["graphs"] == \
        len(port.compiles)


def test_predictor_reload_refills_or_recaptures(mnist_params):
    """New params of the same shapes are copied into the captured ones
    (no capture, the new logits); params of other shapes drop the graphs,
    and each signature recaptures and counts once more."""
    pj, pj2 = mnist_params
    graphs = _cache()
    port = R._Predictor(mnist.predict, pj, 0, "cpu", graphs=graphs)
    bursts = _bursts()[:4]
    for inputs in bursts:
        port(inputs)
    n = graphs.captures
    port.params = pj2
    for inputs in bursts:
        got, _ = port(inputs)
        _logits_close(got["logits"], np.asarray(
            JM.serve_predict(pj2, inputs)["logits"]))
    assert graphs.captures == n and set(port.compiles.values()) == {1}
    wide = dict(pj2, fc1={"w": np.concatenate([pj2["fc1"]["w"]] * 2, 1),
                          "b": np.concatenate([pj2["fc1"]["b"]] * 2)},
                fc2={"w": np.concatenate([pj2["fc2"]["w"]] * 2, 0) / 2,
                     "b": pj2["fc2"]["b"]})
    port.params = wide
    got, _ = port(bursts[0])
    _logits_close(got["logits"], np.asarray(
        JM.serve_predict(wide, bursts[0])["logits"]))
    assert graphs.captures == n + 1 and len(graphs) == 1
    assert port.compiles[str(port._sig(bursts[0]))] == 2


def test_jit_false_never_captures(mnist_params):
    port = R._Predictor(mnist.predict, mnist_params[0], 0, "cpu", jit=False)
    for inputs in _bursts()[:3]:
        port(inputs)
    st = port.stats()
    assert st["graphs"] == 0 and st["eager_signatures"] == len(st["compiles"])


def test_jit_true_on_a_cpu_spec_raises(mnist_params):
    """``jit=True`` needs CUDA graphs: a CPU spec, a CPU predictor and a
    CPU engine raise ValueError; ``jit=None`` and ``False`` serve."""
    with pytest.raises(ValueError, match="CPU"):
        serving.ModelSpec(predict=mnist.predict, params={}, jit=True,
                          device="cpu")
    for jit in (None, False):
        assert serving.ModelSpec(predict=mnist.predict, params={}, jit=jit,
                                 device="cpu").jit is jit
    with pytest.raises(ValueError, match="jit=True"):
        R._Predictor(mnist.predict, mnist_params[0], 0, "cpu", jit=True)
    spec = D.DecodeSpec(_cfg(), slots=2, max_tokens=4)
    eng = D.DecodeEngine(_port_params(0), spec, lambda *a: None,
                         device="cpu", jit=True)
    with pytest.raises(ValueError, match="jit=True"):
        eng.start(timeout=HANG)
    eng.stop()


# -- launch accounting --------------------------------------------------------

def _fake_launch(name="flash_fwd"):
    """What a kernel wrapper does where it launches: count it, unless
    this thread is capturing."""
    if cuda_graphs.launch_counted(name):
        ops.add_launch_counts({name: 1})


def test_replays_count_recorded_launches_and_captures_none():
    """A graph whose capture launched the forward twice and RMSNorm once
    adds exactly that at each replay and nothing at its capture; a
    launch on another thread during the capture counts at once."""
    def step(x):
        _fake_launch()
        _fake_launch()
        _fake_launch("rmsnorm")
        return x + 1

    beside = threading.Thread(target=_fake_launch)

    def capture_with_a_neighbour(fn, inputs, pool):
        # records as cuda_graphs.cuda_capture does, while another thread
        # launches
        with cuda_graphs.recording_launches() as rec:
            beside.start()
            beside.join(HANG)
            graph, out, _ = _plain_capture(fn, inputs, pool)
        return graph, out, rec

    graphs = cuda_graphs.GraphCache("cpu", capture=capture_with_a_neighbour)
    ops.reset_launch_counts()
    g = graphs.capture("k", step, (torch.zeros(3),))
    assert g.launches == {"flash_fwd": 2, "rmsnorm": 1}
    assert ops.launch_counts() == dict(flash_fwd=1, flash_dq=0,
                                       flash_dkv=0, rmsnorm=0)
    for _ in range(3):
        out = g(torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0))
    assert ops.launch_counts() == dict(flash_fwd=7, flash_dq=0,
                                       flash_dkv=0, rmsnorm=3)
    step(torch.zeros(1))                       # eager: counts at once
    assert attention.launches == 9
    with pytest.raises(ValueError, match="captured at"):
        g(torch.ones(4))
    ops.reset_launch_counts()


# -- the decode engine ----------------------------------------------------------

def _cfg(kw=KW):
    return TT.Config(**kw, attn_impl="flash")


@functools.lru_cache(maxsize=None)
def _jax_params(seed, kw=tuple(sorted(KW.items()))):
    return jax.tree_util.tree_map(
        np.asarray, JT.init(jax.random.PRNGKey(seed), JT.Config(**dict(kw))))


def _port_params(seed, kw=KW):
    return TT.params_from_jax(_jax_params(seed, tuple(sorted(kw.items()))),
                              _cfg(kw), device="cpu")


def _oracle(seed, prompt, max_tokens):
    return JT.greedy_decode_reference(
        _jax_params(seed), prompt, JT.Config(**KW, attn_impl="reference"),
        max_tokens=max_tokens,
        attn_fn=functools.partial(jops.mha_reference, causal=True))


def _drive(make, jobs, reload_after=None, params=None, between=None):
    """Queue ``jobs`` [(sid, prompt, max_tokens)] on ``make(emit)``'s
    engine, start it and wait; with ``reload_after``, once that many
    sessions are done call ``between()``, ``set_params(params)`` and
    queue the rest.  Returns ({sid: tokens}, stats)."""
    done, errors = {}, {}
    lock = threading.Lock()

    def emit(kind, sid, *rest):
        with lock:
            if kind == "done":
                done[sid] = list(rest[0])
            elif kind == "error":
                errors[sid] = rest[0]

    eng = make(emit)
    first = jobs if reload_after is None else jobs[:reload_after]
    for sid, prompt, n in first:
        eng.submit(sid, prompt, max_tokens=n)
    eng.start(timeout=HANG)
    try:
        deadline = time.monotonic() + HANG
        while len(done) + len(errors) < len(first):
            assert time.monotonic() < deadline, "hang guard: sessions"
            time.sleep(0.01)
        if reload_after is not None:
            between()
            eng.set_params(params)
            for sid, prompt, n in jobs[reload_after:]:
                eng.submit(sid, prompt, max_tokens=n)
            while len(done) + len(errors) < len(jobs):
                assert time.monotonic() < deadline, "hang guard: sessions"
                time.sleep(0.01)
    finally:
        eng.stop()
    assert not errors, errors
    return done, eng.stats()


def _jobs(seed=0, n=6):
    """Greedy sessions of 3-40 tokens, every other one behind a shared
    16-token prefix (prefix hits in paged mode)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, KW["vocab_size"], size=16).tolist()
    jobs = []
    for i in range(n):
        tail = rng.integers(1, KW["vocab_size"],
                            size=int(rng.integers(3, 25))).tolist()
        jobs.append((f"j{seed}-{i}", (system + tail) if i % 2 else tail, 6))
    return jobs


def _engine(spec, graphs=None, params=None, jit=None):
    """A CPU engine factory for :func:`_drive`: through ``graphs`` (an
    injected cache), or eager with ``jit=False``."""
    params = _port_params(0) if params is None else params
    return lambda emit: D.DecodeEngine(params, spec, emit, device="cpu",
                                       graphs=graphs, jit=jit)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slots"])
def test_engine_through_graphs_equals_eager_and_jax(paged):
    """Every step through an injected graph: the eager engine's tokens and
    the JAX oracle's, each bucket captured once (``graphs`` in stats, no
    eager signature), and in paged mode the prefix hits' tail prefills
    graphed too."""
    spec = D.DecodeSpec(_cfg(), slots=4, paged=paged, block_size=8,
                        prefix_sharing=True, max_tokens=6)
    jobs = _jobs()
    graphs = _cache()
    got, st = _drive(_engine(spec, graphs), jobs)
    want, st_eager = _drive(_engine(spec, jit=False), jobs)
    assert got == want
    for sid, prompt, n in jobs[:3]:
        assert got[sid] == _oracle(0, prompt, n), sid
    assert st["graphs"] == len(graphs) == graphs.captures >= 2
    assert st["eager_signatures"] == 0
    assert st_eager["graphs"] == 0 and st_eager["eager_signatures"] >= 2
    kinds = {k[0] for k in graphs.keys()}
    assert kinds == ({"prefill", "extend", "paged"} if paged
                     else {"prefill", "decode"})
    # every step after a bucket's first replays its graph
    assert sum(graphs.get(k).replays for k in graphs.keys()) > len(graphs)


def test_engine_set_params_refills_its_graphs():
    """A ``set_params`` of the same shapes refills the captured params in
    place: the graphs captured before it stay (no recapture of a seen
    bucket), the sessions after it give the new params' tokens (the
    oracle's and a fresh eager engine's), and the caller's params tensors
    are never written (the engine owns the ones its graphs read)."""
    spec = D.DecodeSpec(_cfg(), slots=4, paged=True, block_size=8,
                        prefix_sharing=True, max_tokens=6)
    jobs = [(f"r{i}", p, n) for i, (_, p, n) in enumerate(_jobs(1, 4))]
    again = [("again", jobs[0][1], 6)]
    params = _port_params(0)
    kept = {k: v.clone() for k, v in params["layers"].items()}
    graphs = _cache()
    seen = {}

    def between():
        seen["keys"], seen["captures"] = set(graphs.keys()), graphs.captures

    new = _port_params(2)
    got, st = _drive(_engine(spec, graphs, params=params), jobs + again,
                     reload_after=len(jobs), params=new, between=between)
    assert st["reloads"] == 1
    assert got["again"] == _oracle(2, jobs[0][1], 6)
    fresh, _ = _drive(_engine(spec, params=new, jit=False), again)
    assert fresh["again"] == got["again"]
    keys = set(graphs.keys())
    assert seen["keys"] <= keys
    assert graphs.captures - seen["captures"] == len(keys - seen["keys"])
    assert all(torch.equal(params["layers"][k], v) for k, v in kept.items())


def test_speculative_engine_through_graphs_equals_eager():
    """The draft's prefill and step and the windowed verify through
    injected graphs: the eager speculative engine's tokens and accept
    counts."""
    spec = D.DecodeSpec(_cfg(), slots=4, paged=True, block_size=8,
                        max_tokens=6, draft_params=_port_params(7, DKW),
                        draft_cfg=_cfg(DKW), spec_window=3)
    jobs = _jobs(3, 4)
    graphs = _cache()
    got, st = _drive(_engine(spec, graphs), jobs)
    want, st_ref = _drive(_engine(spec, jit=False), jobs)
    assert got == want
    assert (st["spec_proposed"], st["spec_accepted"]) == \
        (st_ref["spec_proposed"], st_ref["spec_accepted"])
    assert {"draft_prefill", "draft_decode", "paged"} <= \
        {k[0] for k in graphs.keys()}
    assert st["eager_signatures"] == 0 and st_ref["graphs"] == 0
