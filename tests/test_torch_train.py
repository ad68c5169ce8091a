"""PyTorch port, the training path: ``loss_fn`` and its gradients, remat,
blockwise CE, Adam, gradient accumulation, the step metrics and
``prefetch_to_device``, held against the JAX package on the same numpy
inputs (CPU).

Both packages get the same parameters (JAX ``transformer.init``,
converted by ``params_from_jax``) and the same tokens.  f32 compute.
The JAX flash attention runs its Pallas kernels in interpret mode; the
port's runs its plain forward and backward.  Loss within 1e-5 relative,
every gradient within 2e-4 absolute (tests/test_ops.py's f32 gradient
tolerance), unless a case states otherwise.
"""

import functools
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tensorflowonspark_tpu import infeed as jinfeed  # noqa: E402
from tensorflowonspark_tpu import ops as jops  # noqa: E402
from tensorflowonspark_tpu.models import transformer as JT  # noqa: E402
from tensorflowonspark_tpu.utils import metrics as jmetrics  # noqa: E402
from tensorflowonspark_tpu.utils import train as jtrain  # noqa: E402
from tensorflowonspark_tpu_torch import infeed  # noqa: E402
from tensorflowonspark_tpu_torch import ops as tops  # noqa: E402
from tensorflowonspark_tpu_torch.models import transformer as TT  # noqa: E402
from tensorflowonspark_tpu_torch.utils import metrics  # noqa: E402
from tensorflowonspark_tpu_torch.utils import train  # noqa: E402

KW = dict(vocab_size=128, dim=64, n_layers=2, n_heads=2, max_seq=32,
          dtype="float32")
LOSS_RTOL, GRAD_TOL = 1e-5, 2e-4


def _cfgs(**over):
    kw = {**KW, **over}
    return JT.Config(**kw), TT.Config(**kw)


def _params(cfg_j, cfg_t, seed=0):
    pj = JT.init(jax.random.PRNGKey(seed), cfg_j)
    return pj, TT.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                  cfg_t, device="cpu")


def _tokens(vocab, shape=(2, 32), seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _flat(tree):
    """{dotted name: numpy array} of a params/grads tree of either package."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _flat(v).items()})
        else:
            out[k] = np.asarray(v.detach() if torch.is_tensor(v) else v)
    return out


def _assert_trees_close(got, ref, atol, what=""):
    got, ref = _flat(got), _flat(ref)
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=atol,
                                   err_msg=f"{what} grad {name}")


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _params(cfg_j, cfg_t)
    return cfg_j, cfg_t, pj, pt, _tokens(KW["vocab_size"])


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(attn_impl, **ce):
    """The JAX package's jitted ``value_and_grad(loss_fn)`` at KW, as
    ``f(params, tokens, labels=None)``; one compile per configuration,
    shared by the tests that use it."""
    cfg = JT.Config(**{**KW, "attn_impl": attn_impl})
    return jax.jit(jax.value_and_grad(
        lambda p, toks, labels=None: JT.loss_fn(p, toks, cfg, labels=labels,
                                                **ce)))


def _labels_with_ignores(tokens):
    labels = np.roll(tokens, -1, axis=1).copy()
    labels[:, -1] = -1
    labels[0, :5] = -1  # a masked prefix
    return labels


@pytest.mark.parametrize("attn_impl", ["flash", "reference"])
@pytest.mark.parametrize("ce", ["dense", "blockwise", "dense-labels"])
def test_loss_and_grads_match_jax(model, attn_impl, ce):
    """loss_fn's value and every parameter's gradient against
    ``jax.value_and_grad(transformer.loss_fn)``: flash and reference
    attention, dense and blockwise (block 32) CE, and explicit labels
    with -1 ignores."""
    _, _, pj, pt, toks = model
    cfg_t = TT.Config(**{**KW, "attn_impl": attn_impl})
    ce_kw, labels = {}, None
    if ce == "blockwise":
        ce_kw = dict(ce_impl="blockwise", ce_block=32)
    elif ce == "dense-labels":
        labels = _labels_with_ignores(toks)
    ref_loss, ref_grads = _jax_value_and_grad(attn_impl, **ce_kw)(
        pj, jnp.asarray(toks),
        labels=None if labels is None else jnp.asarray(labels))
    loss, grads = train.value_and_grad(
        lambda p: TT.loss_fn(p, toks, cfg_t, labels=labels, **ce_kw))(pt)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    _assert_trees_close(grads, ref_grads, GRAD_TOL, f"{attn_impl}/{ce}")


def test_blockwise_block48_matches_jax_and_indivisible_raises():
    """A 48-wide vocab block (vocab 96: two blocks) against the JAX
    loss and gradients; a block that does not divide the vocab raises
    the reference's ValueError in both packages."""
    cfg_j, cfg_t = _cfgs(vocab_size=96, attn_impl="reference")
    pj, pt = _params(cfg_j, cfg_t, seed=1)
    toks = _tokens(96, seed=1)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jnp.asarray(toks), cfg_j,
                             ce_impl="blockwise", ce_block=48)))(pj)
    loss, grads = train.value_and_grad(
        lambda p: TT.loss_fn(p, toks, cfg_t, ce_impl="blockwise",
                             ce_block=48))(pt)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    _assert_trees_close(grads, ref_grads, GRAD_TOL, "block48")
    with pytest.raises(ValueError, match="not divisible by ce_block 64"):
        # raised while tracing, before anything is compiled
        jax.jit(lambda p, t: JT.loss_fn(p, t, cfg_j, ce_impl="blockwise",
                                        ce_block=64))(pj, jnp.asarray(toks))
    with pytest.raises(ValueError, match="not divisible by ce_block 64"):
        TT.loss_fn(pt, toks, cfg_t, ce_impl="blockwise", ce_block=64)
    with pytest.raises(ValueError, match="unknown ce_impl"):
        TT.loss_fn(pt, toks, cfg_t, ce_impl="sparse")


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_remat_matches_no_remat(model, attn_impl):
    """remat=True and remat="dots" change what the backward keeps, not
    the math: loss and gradients equal no remat, mirroring
    tests/test_transformer.py's remat case (rtol 1e-6 loss, rtol 1e-5 /
    atol 1e-6 grads).  With flash attention this runs the port's autograd
    Function under checkpoint and under the selective policy."""
    _, _, _, pt, toks = model
    cfg = TT.Config(**{**KW, "attn_impl": attn_impl})
    base_loss, base_grads = train.value_and_grad(
        lambda p: TT.loss_fn(p, toks, cfg))(pt)
    for mode in (True, "dots"):
        loss, grads = train.value_and_grad(
            lambda p, m=mode: TT.loss_fn(p, toks, cfg, remat=m))(pt)
        np.testing.assert_allclose(float(loss), float(base_loss), rtol=1e-6,
                                   err_msg=f"remat={mode}")
        g, b = _flat(grads), _flat(base_grads)
        for name in b:
            np.testing.assert_allclose(g[name], b[name], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{mode} {name}")
    with pytest.raises(ValueError, match="remat must be bool or 'dots'"):
        TT.loss_fn(pt, toks, cfg, remat="everything")


def test_remat_dots_saves_matmuls_and_full_remat_recomputes_them(model):
    """What each policy keeps: counted aten.mm calls in the backward.
    Full remat re-runs the layer matmuls (all but w2, whose output no
    backward reads: the recompute stops after the last saved tensor);
    "dots" re-runs none of them."""
    _, _, _, pt, toks = model
    cfg = TT.Config(**{**KW, "attn_impl": "reference"})
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.mm += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for mode in (False, True, "dots"):
        params = {k: ({kk: vv.detach().clone().requires_grad_()
                       for kk, vv in v.items()} if isinstance(v, dict)
                      else v.detach().clone().requires_grad_())
                  for k, v in pt.items()}
        loss = TT.loss_fn(params, toks, cfg, remat=mode)
        with CountMM() as c:
            loss.backward()
        counts[mode] = c.mm
    per_layer = 3  # wqkv, wo, w1 forward matmuls
    assert counts[True] == counts[False] + per_layer * KW["n_layers"]
    assert counts["dots"] == counts[False]


def test_positions_need_an_attn_fn_and_match_jax(model):
    """``positions=`` without an ``attn_fn`` raises in both packages; with
    one, rope by global position (table max(S, max_seq)) gives the JAX
    logits."""
    cfg_j, cfg_t, pj, pt, toks = model
    toks = toks[:, :16]
    pos = (np.arange(16) + 12).astype(np.int32)
    with pytest.raises(ValueError, match="positions= implies"):
        JT.apply(pj, jnp.asarray(toks), cfg_j, positions=jnp.asarray(pos))
    with pytest.raises(ValueError, match="positions= implies"):
        TT.apply(pt, toks, cfg_t, positions=pos)
    with pytest.raises(ValueError, match="positions= implies"):
        TT.loss_fn(pt, toks, cfg_t, positions=pos)
    ref = JT.apply(pj, jnp.asarray(toks), cfg_j, positions=jnp.asarray(pos),
                   attn_fn=lambda q, k, v: jops.mha_reference(q, k, v,
                                                              causal=True))
    got = TT.apply(pt, toks, cfg_t, positions=pos,
                   attn_fn=lambda q, k, v: tops.mha_reference(q, k, v,
                                                              causal=True))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4)


def test_apply_logits_dtype_and_return_hidden(model):
    _, cfg_t, _, pt, toks = model
    cfg = TT.Config(**{**KW, "dtype": "bfloat16"})
    with torch.no_grad():
        assert TT.apply(pt, toks, cfg).dtype == torch.float32
        assert TT.apply(pt, toks, cfg, logits_dtype=None).dtype == \
            torch.bfloat16
        hid = TT.apply(pt, toks, cfg_t, return_hidden=True)
    assert hid.shape == (2, 32, KW["dim"])


def _adam_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


def test_adam_matches_optax():
    """torch.optim.Adam(1e-3, betas=(0.9, 0.999), eps=1e-8) against
    ``optax.adam(1e-3)`` (bench.py's optimizer) from identical params
    over three identical gradients (rtol 1e-6: the same update, summed
    in another order)."""
    params, grads = _adam_inputs()
    opt = optax.adam(1e-3)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(pj)
    pt = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    topt = torch.optim.Adam(pt.values(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state)
        pj = optax.apply_updates(pj, upd)
        for k, t in pt.items():
            t.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for k in params:
            np.testing.assert_allclose(pt[k].detach().numpy(),
                                       np.asarray(pj[k]), rtol=1e-6,
                                       atol=1e-7)


def test_two_train_steps_match_jax(model):
    """The slice as a whole on the CPU: batches through
    ``prefetch_to_device``, flash-attention ``loss_fn`` differentiated by
    autograd, Adam(1e-3); the JAX package's value_and_grad + optax on
    the same params and tokens.  Losses within 1e-5 relative, params
    within 1e-5 after two steps (an Adam step moves each weight by
    ~1e-3, so a wrong gradient sign or scale shows)."""
    _, cfg_t, pj, pt, _ = model
    batches = [_tokens(KW["vocab_size"], seed=s) for s in (3, 4)]
    opt = optax.adam(1e-3)
    state = opt.init(pj)
    ref_losses = []
    vg = _jax_value_and_grad("flash")

    @jax.jit
    def adam_step(p, g, state):
        upd, state = opt.update(g, state)
        return optax.apply_updates(p, upd), state

    for toks in batches:
        loss, g = vg(pj, jnp.asarray(toks))
        pj, state = adam_step(pj, g, state)
        ref_losses.append(float(loss))
    params = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.clone().requires_grad_())
              for k, v in pt.items()}
    leaves = [params["embed"], params["ln_f"], params["head"],
              *params["layers"].values()]
    topt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for toks in infeed.prefetch_to_device(iter(batches), placement="cpu"):
        loss = TT.loss_fn(params, toks, cfg_t)
        topt.zero_grad(set_to_none=True)
        loss.backward()
        topt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    _assert_trees_close(params, pj, 1e-5, "after two steps:")


# -- utils/train.py ----------------------------------------------------------

def _lin_loss_j(params, x, y):
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)


def _lin_loss_t(params, x, y):
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2)


def _lin_setup(n=32, d=4):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(d,)).astype(np.float32),
              "b": np.float32(0.1)}
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    pt = {k: torch.tensor(v) for k, v in params.items()}
    return params, pt, x, y


@pytest.mark.parametrize("accum", [1, 2, 8])
def test_accumulated_grads_match_full_batch(accum):
    """Mirrors tests/test_train_utils.py: the mean over microbatches is
    the full batch's loss and gradient (rtol 1e-5 loss, 1e-4 grads), and
    equals the JAX package's accumulated value."""
    params, pt, x, y = _lin_setup()
    full_loss, full_grads = train.value_and_grad(_lin_loss_t)(
        pt, torch.from_numpy(x), torch.from_numpy(y))
    loss, grads = train.accumulated_value_and_grad(_lin_loss_t, accum)(
        pt, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(full_loss), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(grads[k].numpy(), full_grads[k].numpy(),
                                   rtol=1e-4, atol=1e-6)
    jloss, jgrads = jtrain.accumulated_value_and_grad(_lin_loss_j, accum)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-4, atol=1e-6)
    assert pt["w"].grad is None  # the caller's tensors are left alone


def test_accumulated_has_aux_and_carry_aux():
    params, pt, x, y = _lin_setup()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def loss_aux(p, x, y):
        return _lin_loss_t(p, x, y), {"seen": x.shape[0]}

    (loss, aux), _ = train.accumulated_value_and_grad(
        loss_aux, 4, has_aux=True)(pt, xt, yt)
    assert aux["seen"] == 8  # the last microbatch's aux
    full, _ = train.value_and_grad(_lin_loss_t)(pt, xt, yt)
    np.testing.assert_allclose(float(loss), float(full), rtol=1e-5)

    def loss_carry(p, count, x, y):
        return _lin_loss_t(p, x, y), count + x.shape[0]

    (loss, count), _ = train.accumulated_value_and_grad(
        loss_carry, 4, has_aux=True, carry_aux=True)(pt, xt, yt, init_aux=5)
    assert count == 5 + 32  # advanced once per microbatch
    with pytest.raises(ValueError, match="requires init_aux"):
        train.accumulated_value_and_grad(
            loss_carry, 4, has_aux=True, carry_aux=True)(pt, xt, yt)
    with pytest.raises(ValueError, match="carry_aux requires has_aux"):
        train.accumulated_value_and_grad(loss_carry, 4, carry_aux=True)
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        train.accumulated_value_and_grad(_lin_loss_t, 0)


def test_indivisible_batch_raises():
    _, pt, x, y = _lin_setup(n=30)
    with pytest.raises(ValueError, match="divisible"):
        train.accumulated_value_and_grad(_lin_loss_t, 8)(
            pt, torch.from_numpy(x), torch.from_numpy(y))


def test_transformer_accum_matches_full_batch():
    """On the model: 4 microbatches of 2 equal the batch of 8 (rtol 1e-5
    loss, rtol 1e-4 / atol 1e-6 grads, tests/test_train_utils.py's)."""
    cfg = TT.Config(vocab_size=64, dim=32, n_layers=2, n_heads=2,
                    max_seq=16, dtype="float32", attn_impl="flash")
    pt = TT.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(64, (8, 16)).astype(np.int64))

    def loss(p, t):
        return TT.loss_fn(p, t, cfg)

    full_loss, full_grads = train.value_and_grad(loss)(pt, toks)
    loss_a, grads_a = train.accumulated_value_and_grad(loss, 4)(pt, toks)
    np.testing.assert_allclose(float(loss_a), float(full_loss), rtol=1e-5)
    g, f = _flat(grads_a), _flat(full_grads)
    for name in f:
        np.testing.assert_allclose(g[name], f[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_global_norm_and_health_probe_match_jax(monkeypatch):
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    np.testing.assert_allclose(
        float(train.global_norm(ttree)),
        float(jtrain.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))),
        rtol=1e-6)
    assert float(train.global_norm({})) == 0.0
    monkeypatch.delenv(train.GRADNORM_ENV, raising=False)
    assert train.health_probe(1.0, ttree) is None
    monkeypatch.setenv(train.GRADNORM_ENV, "1")
    probe = train.health_probe(torch.tensor(1.0), ttree)
    assert bool(probe["finite"])
    np.testing.assert_allclose(float(probe["grad_norm"]),
                               float(train.global_norm(ttree)))
    assert not bool(train.health_probe(float("nan"), ttree)["finite"])
    split = train.split_microbatches((torch.zeros(6, 2), torch.zeros(6)), 3)
    assert split[0].shape == (3, 2, 2) and split[1].shape == (3, 2)


# -- utils/metrics.py --------------------------------------------------------

def test_transformer_flops_and_peak_flops(monkeypatch):
    cfg_j = JT.Config(vocab_size=16384, dim=1024, n_layers=8, n_heads=8,
                      max_seq=2048)
    cfg_t = TT.Config(vocab_size=16384, dim=1024, n_layers=8, n_heads=8,
                      max_seq=2048)
    for causal in (False, True):
        assert metrics.transformer_flops_per_token(cfg_t, causal=causal) == \
            jmetrics.transformer_flops_per_token(cfg_j, causal=causal)
    monkeypatch.delenv("TFOS_PEAK_FLOPS", raising=False)
    assert metrics.peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert metrics.peak_flops("cuda:0") == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "Some Other GPU")
    assert metrics.peak_flops("cuda:0") is None
    monkeypatch.setenv("TFOS_PEAK_FLOPS", "1e12")
    assert metrics.peak_flops("cpu") == 1e12


def test_train_metrics_report(monkeypatch):
    """Rates count timed steps only (the first step() arms the timer);
    MFU = items * flops / time / peak; a health monitor sees each step;
    a planned ``nan`` poisons the loss it is handed."""
    monkeypatch.setenv("TFOS_PEAK_FLOPS", "1000")
    monkeypatch.setenv("TFOS_FAULT_PLAN", "train.step:nan@2")
    seen = []

    class Monitor:
        def observe_step(self, **kw):
            seen.append(kw)

    m = metrics.TrainMetrics(flops_per_item=2.0, device="cpu",
                             health=Monitor())
    m.step(items=10, loss=1.5)
    time.sleep(0.01)
    m.step(items=10, loss=1.0)
    m.infeed_wait(0.001)
    time.sleep(0.01)
    m.step(items=10, loss=0.5)
    rep = m.report()
    assert rep["steps"] == 3 and rep["items"] == 20
    assert rep["items_per_sec"] == pytest.approx(20 / m.step_time)
    assert rep["mfu"] == pytest.approx(20 * 2.0 / m.step_time / 1000)
    assert 0 < rep["infeed_stall_frac"] < 1
    assert [s["step"] for s in seen] == [1, 2, 3]
    assert seen[0]["step_time_s"] is None and seen[2]["step_time_s"] > 0
    assert seen[0]["loss"] == 1.5 and np.isnan(seen[1]["loss"])
    m.reset()
    assert m.report()["steps"] == 0


# -- infeed.prefetch_to_device -----------------------------------------------

def test_prefetch_preserves_order_and_values():
    """Mirrors tests/test_infeed.py: order and values survive; numpy
    leaves arrive as CPU tensors, tree structure kept."""
    batches = [(np.full((4,), i), {"y": np.arange(i, i + 2)})
               for i in range(10)]
    out = list(infeed.prefetch_to_device(iter(batches), depth=3,
                                         placement="cpu"))
    assert len(out) == 10
    for i, (x, d) in enumerate(out):
        assert torch.is_tensor(x) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), np.full((4,), i))
        np.testing.assert_array_equal(d["y"].numpy(), np.arange(i, i + 2))
    ref = list(jinfeed.prefetch_to_device(iter(batches), depth=3))
    assert len(ref) == len(out)


def test_prefetch_forwards_worker_exception():
    def gen():
        yield np.zeros((2,))
        raise ValueError("boom in feed")

    it = infeed.prefetch_to_device(gen(), depth=2, placement="cpu")
    next(it)
    with pytest.raises(ValueError, match="boom in feed"):
        list(it)


def test_prefetch_default_placement_needs_a_card(monkeypatch):
    """placement=None means the card: without one it raises at the first
    batch instead of staging on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    it = infeed.prefetch_to_device(iter([np.zeros(2)]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(it)


def test_prefetch_callable_placement():
    out = list(infeed.prefetch_to_device(
        iter([np.ones(3), np.zeros(3)]),
        placement=lambda b: torch.from_numpy(b) * 2))
    assert [o.tolist() for o in out] == [[2.0] * 3, [0.0] * 3]


def test_prefetch_abandon_calls_hook_once_and_stages_nothing_more():
    """Early close: ``on_abandon`` runs once, the worker exits promptly,
    and no batch is staged after the cancel (mirrors
    tests/test_infeed.py's abandon cases)."""
    unblock = threading.Event()
    pulled, placed, hooks = [], [], []

    def source():
        for i in range(100):
            if i >= 3:
                unblock.wait(timeout=10)
            pulled.append(i)
            yield np.full(2, i)

    def place(b):
        placed.append(int(b[0]))
        return torch.from_numpy(b)

    def hook():
        hooks.append(1)
        unblock.set()

    it = infeed.prefetch_to_device(source(), depth=2, placement=place,
                                   on_abandon=hook)
    assert next(it).tolist() == [0, 0]
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < 4
    assert hooks == [1]
    n_placed = len(placed)
    time.sleep(0.3)
    assert len(placed) == n_placed  # nothing staged after the cancel
    assert n_placed <= 4  # depth 2 ahead, one in flight, one consumed
    live = [t.name for t in threading.enumerate()
            if t.name == "tfos-prefetch" and t.is_alive()]
    assert not live, f"prefetch worker leaked: {live}"


def test_prefetch_abandon_with_failing_hook_exits_early():
    def forever():
        yield np.zeros(2)
        time.sleep(6)
        yield np.zeros(2)

    def bad_hook():
        raise RuntimeError("hook failed to unblock the source")

    it = infeed.prefetch_to_device(forever(), depth=2, placement="cpu",
                                   on_abandon=bad_hook)
    next(it)
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < 4
