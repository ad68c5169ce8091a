"""PyTorch port, models/transformer.py at head_dims 80, 256 and 512 and in
float16, against the JAX model on the CPU.

Two-layer configs whose head_dim is Pythia-2.8B's and Phi-2's (dim 160, 2
heads: 80), Gemma-2B's (dim 512, 2 heads: 256) and the main transformer's
width at 2 heads (dim 1024: 512, the chunked kernels'),
``attn_impl="flash"``
in both packages (the JAX forward runs its Pallas kernel in interpret
mode, the port its plain flash versions), compute in float32 and float16.
Params are the JAX ``init``'s, converted by ``params_from_jax``; tokens
are numpy-seeded.  Held: ``apply``'s logits, ``loss_fn`` and its
gradient on every parameter, and the greedy tokens of the port's
``DecodeEngine`` against the JAX package's ``DecodeEngine``.

Tolerances.  float32: the forward to 1e-4 of the largest logit and the
loss to 1e-5 relative, both sides f32 in another order (as
tests/test_torch_transformer.py); gradients to 1e-4 of each leaf's
largest element.  float16: both sides round every matmul and activation
to fp16 (11 significant bits), in other orders, so single elements may
sit one fp16 rounding (2^-10 relative) apart at any layer and carry that
on through two layers and the head: logits to 2^-8 of the largest logit,
the loss (an f32 mean) to 2^-10 relative, gradients to 2^-7 of each
leaf's largest element, the global relative norm of the gradients'
difference to 2^-8 (measured: at most 1.0e-3, 5.7e-5, 2.3e-3 and 1.7e-3).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu.models import transformer as JT  # noqa: E402
from tensorflowonspark_tpu.serving.decode import scheduler as JD  # noqa: E402
from tensorflowonspark_tpu_torch.models import transformer as TT  # noqa: E402
from tensorflowonspark_tpu_torch.serving.decode import (  # noqa: E402
    scheduler as TD,
)

WIDTHS = {80: dict(dim=160, n_heads=2), 256: dict(dim=512, n_heads=2),
          512: dict(dim=1024, n_heads=2)}
TOL = {"float32": dict(logits=1e-4, loss=1e-5, grad=1e-4, grad_norm=1e-5),
       "float16": dict(logits=2.0 ** -8, loss=2.0 ** -10, grad=2.0 ** -7,
                       grad_norm=2.0 ** -8)}
HANG = 300.0


def _kw(head_dim, dtype):
    return dict(vocab_size=97, n_layers=2, max_seq=64, dtype=dtype,
                attn_impl="flash", **WIDTHS[head_dim])


_PARAMS = {}


def _params(head_dim):
    """(JAX params, their numpy tree) for the width, shared by dtypes."""
    if head_dim not in _PARAMS:
        cfg = JT.Config(**_kw(head_dim, "float32"))
        pj = JT.init(jax.random.PRNGKey(head_dim), cfg)
        _PARAMS[head_dim] = (pj, jax.tree_util.tree_map(np.asarray, pj))
    return _PARAMS[head_dim]


def _leaves(tree):
    return [tree["embed"], tree["ln_f"], tree["head"],
            *(tree["layers"][k] for k in sorted(tree["layers"]))]


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("head_dim", [80, 256, 512])
def test_logits_loss_and_grads_match_jax(head_dim, dtype):
    """apply's logits, the loss and every parameter's gradient of the
    port equal the JAX model's at the width and dtype."""
    kw = _kw(head_dim, dtype)
    cfg_j, cfg_t = JT.Config(**kw), TT.Config(**kw)
    assert cfg_t.head_dim == head_dim
    pj, tree = _params(head_dim)
    pt = TT.params_from_jax(tree, cfg_t, device="cpu")
    toks = np.random.default_rng(head_dim).integers(
        0, kw["vocab_size"], (2, 48)).astype(np.int32)
    tol = TOL[dtype]

    ref = np.asarray(JT.apply(pj, jnp.asarray(toks), cfg_j), np.float32)
    got = TT.apply(pt, torch.from_numpy(toks).long(), cfg_t)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= tol["logits"] * scale

    loss_j, grads_j = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jnp.asarray(toks), cfg_j))(pj)
    leaves = _leaves(pt)
    for x in leaves:
        x.requires_grad_(True)
    loss_t = TT.loss_fn(pt, torch.from_numpy(toks).long(), cfg_t)
    grads_t = torch.autograd.grad(loss_t, leaves)
    assert abs(loss_t.item() - float(loss_j)) <= tol["loss"] * abs(
        float(loss_j))
    num = den = 0.0
    for gt, gj in zip(grads_t, _leaves(grads_j)):
        gj = np.asarray(gj, np.float32)
        assert np.isfinite(gt.numpy()).all()
        big = np.abs(gj).max()
        assert np.abs(gt.numpy() - gj).max() <= tol["grad"] * big
        num += float(((gt.numpy() - gj) ** 2).sum())
        den += float((gj ** 2).sum())
    assert (num / den) ** 0.5 <= tol["grad_norm"]


def _run(engine_cls, params, spec, prompts, max_tokens, **kw):
    """Greedy tokens of each prompt through a decode engine."""
    done, errors, lock = {}, {}, threading.Lock()

    def emit(kind, sid, *rest):
        with lock:
            if kind == "done":
                done[sid] = [int(t) for t in rest[0]]
            elif kind == "error":
                errors[sid] = rest[0]

    eng = engine_cls(params, spec, emit, **kw).start(timeout=HANG)
    try:
        for sid, prompt in enumerate(prompts):
            eng.submit(sid, prompt, max_tokens=max_tokens)
        deadline = time.time() + HANG
        while len(done) + len(errors) < len(prompts) and \
                time.time() < deadline:
            time.sleep(0.01)
    finally:
        eng.stop()
    assert not errors, errors
    assert len(done) == len(prompts), "hang guard"
    return [done[i] for i in range(len(prompts))]


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("head_dim", [80, 256, 512])
def test_decode_engine_greedy_tokens_match_jax_engine(head_dim, dtype):
    """The port's DecodeEngine (the flash prefill; slot cache, and paged
    cache with prefix sharing) gives the JAX package's DecodeEngine's
    greedy tokens on the same params and prompts."""
    kw = _kw(head_dim, dtype)
    pj, tree = _params(head_dim)
    cfg_t = TT.Config(**kw)
    pt = TT.params_from_jax(tree, cfg_t, device="cpu")
    rng = np.random.default_rng(head_dim + 1)
    prompts = [rng.integers(0, kw["vocab_size"], n).tolist()
               for n in (7, 12)]
    spec = dict(slots=2, max_tokens=8, paged=False)
    ref = _run(JD.DecodeEngine, pj, JD.DecodeSpec(JT.Config(**kw), **spec),
               prompts, 8)
    got = _run(TD.DecodeEngine, pt, TD.DecodeSpec(cfg_t, **spec), prompts,
               8, device="cpu")
    assert got == ref
    paged = dict(spec, paged=True, block_size=4, prefix_sharing=True)
    got = _run(TD.DecodeEngine, pt, TD.DecodeSpec(cfg_t, **paged),
               prompts + prompts[:1], 8, device="cpu")
    assert got == ref + ref[:1]
