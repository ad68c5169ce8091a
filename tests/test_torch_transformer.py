"""PyTorch port, models/transformer.py: the port's forward and KV-cached
decode steps held against the JAX model on converted parameters (CPU).

Both packages get the same parameters (``transformer.init`` in JAX,
converted by ``params_from_jax``) and the same numpy inputs.  f32
compute; logits within 1e-4, k/v within 1e-5, live rows only (free-slot
rows are garbage by contract).  The JAX prefill runs the Pallas flash
kernel in interpret mode, the port's runs the plain flash version.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu.models import transformer as JT  # noqa: E402
from tensorflowonspark_tpu_torch.models import transformer as TT  # noqa: E402

KW = dict(vocab_size=61, dim=32, n_layers=2, n_heads=2, max_seq=32,
          dtype="float32", attn_impl="flash")
CFG_J = JT.Config(**KW)
CFG_T = TT.Config(**KW)
LOGIT_TOL, KV_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def params():
    pj = JT.init(jax.random.PRNGKey(0), CFG_J)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, TT.params_from_jax(tree, CFG_T, device="cpu")


@pytest.fixture(scope="module")
def prefilled(params):
    """One JAX flash prefill (the slow part, ~3 s) shared by the tests."""
    pj, pt = params
    rng = np.random.default_rng(0)
    toks = rng.integers(0, KW["vocab_size"], size=(3, 16)).astype(np.int32)
    lens = np.array([16, 9, 4], np.int32)
    ref = JT.prefill(pj, jnp.asarray(toks), CFG_J, lengths=lens)
    got = TT.prefill(pt, toks, CFG_T, lengths=lens)
    return toks, lens, [np.asarray(a) for a in ref], got


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol,
                               err_msg=what)


def test_init_shapes_and_scales():
    g = torch.Generator().manual_seed(0)
    cfg = TT.Config(vocab_size=512, dim=128, n_layers=2, n_heads=2,
                    max_seq=64, dtype="float32")
    p = TT.init(cfg, g, "cpu")
    ref = jax.tree_util.tree_map(
        lambda a: a.shape,
        jax.eval_shape(lambda: JT.init(jax.random.PRNGKey(0), JT.Config(
            vocab_size=512, dim=128, n_layers=2, n_heads=2, max_seq=64))))
    got = {k: (tuple(v.shape) if k != "layers" else
               {n: tuple(t.shape) for n, t in v.items()})
           for k, v in p.items()}
    assert got == ref
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    assert abs(p["layers"]["w1"].std().item() - math.sqrt(2 / 128)) < 5e-3
    assert abs(p["layers"]["w2"].std().item() - math.sqrt(2 / 512)) < 3e-3
    assert bool((p["layers"]["ln1"] == 1).all())
    again = TT.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["head"], p["head"])  # seeded


def test_params_from_jax_checks_shapes(params):
    pj, _ = params
    tree = jax.tree_util.tree_map(np.asarray, pj)
    with pytest.raises(ValueError, match=r"embed: shape \(61, 32\)"):
        TT.params_from_jax(tree, TT.Config(**{**KW, "dim": 16}),
                           device="cpu")


def test_apply_logits_match_jax(params):
    pj, pt = params
    toks = np.random.default_rng(1).integers(0, 61, (2, 12)).astype(np.int32)
    ref = JT.apply(pj, jnp.asarray(toks), JT.Config(
        **{**KW, "attn_impl": "reference"}))
    got = TT.apply(pt, toks, TT.Config(**{**KW, "attn_impl": "reference"}))
    _close(got, ref, LOGIT_TOL, "apply logits")


def test_prefill_logits_k_v_match_jax(prefilled):
    toks, lens, (lj, kj, vj), (lt, kt, vt) = prefilled
    assert lt.shape == (3, 61) and kt.shape == (3, 2, 2, 16, 16)
    _close(lt, lj, LOGIT_TOL, "prefill logits")
    for r, n in enumerate(lens):  # real positions only
        _close(kt[r, :, :, :n], kj[r, :, :, :n], KV_TOL, "prefill k")
        _close(vt[r, :, :, :n], vj[r, :, :, :n], KV_TOL, "prefill v")


def test_compute_params_is_numerically_identical(params):
    _, pt = params
    cfg = TT.Config(**{**KW, "dtype": "bfloat16"})
    toks = np.random.default_rng(2).integers(0, 61, (2, 8)).astype(np.int32)
    a = TT.prefill(pt, toks, cfg)
    b = TT.prefill(TT.compute_params(pt, cfg), toks, cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_decode_step_matches_jax(params, prefilled):
    pj, pt = params
    toks, lens, (_, kj, vj), _ = prefilled
    slots, m = 4, KW["max_seq"]
    shape = (slots, 2, 2, m, 16)
    ck = np.zeros(shape, np.float32)
    cv = np.zeros(shape, np.float32)
    ck[:3, :, :, :16], cv[:3, :, :, :16] = kj, vj
    lengths = np.array([16, 9, 4, 0], np.int32)    # slot 3 is free
    step = np.array([5, 7, 11, 0], np.int32)
    lj, nkj, nvj = JT.decode_step(pj, jnp.asarray(step), CFG_J,
                                  jnp.asarray(ck), jnp.asarray(cv),
                                  jnp.asarray(lengths))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    lt, nkt, nvt = TT.decode_step(pt, step, CFG_T, tk, tv, lengths)
    assert nkt is tk  # updated in place
    _close(lt[:3], np.asarray(lj)[:3], LOGIT_TOL, "decode logits")
    for s in range(3):
        n = lengths[s] + 1
        _close(nkt[s, :, :, :n], np.asarray(nkj)[s, :, :, :n], KV_TOL, "k")
        _close(nvt[s, :, :, :n], np.asarray(nvj)[s, :, :, :n], KV_TOL, "v")


def _paged_case(rng, bs=4, slots=3, nbs=8):
    nb = 1 + 2 * slots * nbs
    shape = (nb, 2, 2, bs, 16)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    tables = np.zeros((slots, nbs), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    tables[0, :5] = perm[:5]           # 20 positions mapped
    tables[1, :8] = perm[5:13]         # full table: a window can overflow
    return pk, pv, tables


@pytest.mark.parametrize("w", [1, 3])
def test_decode_step_paged_matches_jax(params, w):
    pj, pt = params
    rng = np.random.default_rng(10 + w)
    pk, pv, tables = _paged_case(rng)
    lengths = np.array([13, 30, 0], np.int32)   # slot 2 free (sentinel)
    toks = rng.integers(0, 61, (3, w)).astype(np.int32)
    lj, nkj, nvj = JT.decode_step_paged(
        pj, jnp.asarray(toks), CFG_J, jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lengths))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    lt, nkt, nvt = TT.decode_step_paged(pt, toks, CFG_T, tk, tv, tables,
                                        lengths)
    assert lt.shape == (3, w, 61) and nkt is tk
    cap = tables.shape[1] * pk.shape[3]
    for s in range(2):
        rows = min(w, cap - lengths[s])   # overflow rows miss history
        _close(lt[s, :rows], np.asarray(lj)[s, :rows], LOGIT_TOL,
               f"paged logits slot {s}")
    # every block but the sentinel (the only repeated write target)
    _close(nkt[1:], np.asarray(nkj)[1:], KV_TOL, "paged pool k")
    _close(nvt[1:], np.asarray(nvj)[1:], KV_TOL, "paged pool v")


def test_prefill_extend_matches_jax(params):
    pj, pt = params
    rng = np.random.default_rng(20)
    pk, pv, tables = _paged_case(rng)
    ptab = np.zeros((2, 4), np.int32)
    ptab[0, :2] = tables[0, :2]            # 8-token prefix
    ptab[1, :4] = tables[1, :4]            # 16-token prefix
    plens = np.array([8, 16], np.int32)
    toks = rng.integers(0, 61, (2, 8)).astype(np.int32)
    lens = np.array([8, 3], np.int32)
    lj, kj, vj = JT.prefill_extend(
        pj, jnp.asarray(toks), CFG_J, jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(ptab), jnp.asarray(plens), lengths=jnp.asarray(lens))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    lt, kt, vt = TT.prefill_extend(pt, toks, CFG_T, tk, tv, ptab, plens,
                                   lengths=lens)
    _close(lt, lj, LOGIT_TOL, "extend logits")
    _close(kt, kj, KV_TOL, "extend k")
    _close(vt, vj, KV_TOL, "extend v")
    assert torch.equal(tk, torch.from_numpy(pk))  # pools only read


def test_greedy_reference_matches_jax(params):
    import functools

    from tensorflowonspark_tpu import ops as jops
    from tensorflowonspark_tpu_torch import ops as tops
    pj, pt = params
    prompt = [7, 11, 13, 17, 19]
    ref = JT.greedy_decode_reference(
        pj, prompt, CFG_J, max_tokens=5,
        attn_fn=functools.partial(jops.mha_reference, causal=True))
    got = TT.greedy_decode_reference(
        pt, prompt, CFG_T, max_tokens=5,
        attn_fn=functools.partial(tops.mha_reference, causal=True))
    assert got == ref
