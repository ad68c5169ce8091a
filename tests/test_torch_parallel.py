"""PyTorch port, the parallel layer (``parallel/``, ``models/moe.py``, the
transformer's tensor-parallel plan, ``restore_any(target_shardings=)``)
against the JAX package: every case of ``tests/test_mesh.py``,
``tests/test_ring.py`` and ``tests/test_pp_moe.py``, each as the JAX
function on a 4-device CPU mesh and the port's on 4 gloo ranks (one
process a rank, started once for the file: ``RankPool``), fed the same
numpy inputs; the ranks' blocks are assembled here and compared.

Tolerances are the JAX tests': attention outputs 2e-5 and gradients
2e-4 absolute; the pipeline 1e-5 and its gradients 1e-4; MoE 1e-5;
the zigzag LM loss 1e-5 relative and its gradients ``rtol=1e-4,
atol=1e-5``.  The tensor-parallel transformer (tp=2 x fsdp=2) against
the unsharded JAX loss: the loss within 1e-5 relative, every gradient
within 1e-4 of its leaf's largest element.  The fsdp ResNet step
against the JAX step jitted with ``shard_train_state``'s shardings:
``tests/test_torch_sync_bn.py``'s bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from tensorflowonspark_tpu import ops as jops  # noqa: E402
from tensorflowonspark_tpu import parallel as JP  # noqa: E402
from tensorflowonspark_tpu.models import moe as JMOE  # noqa: E402
from tensorflowonspark_tpu.models import resnet as JR  # noqa: E402
from tensorflowonspark_tpu.models import transformer as JT  # noqa: E402
from tensorflowonspark_tpu.parallel import mesh as JM  # noqa: E402
from tensorflowonspark_tpu.parallel.ring import shard_map  # noqa: E402
from tensorflowonspark_tpu.utils import checkpoint as JC  # noqa: E402
from tensorflowonspark_tpu_torch import parallel as TP  # noqa: E402
from tensorflowonspark_tpu_torch.models import moe as MOE  # noqa: E402
from tensorflowonspark_tpu_torch.models import resnet as R  # noqa: E402
from tensorflowonspark_tpu_torch.models import transformer as TT  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import mesh as TM  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import ring as TR  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import sharding as TS  # noqa: E402
from tensorflowonspark_tpu_torch.parallel.launch import RankPool  # noqa: E402
from tensorflowonspark_tpu_torch.utils import checkpoint as C  # noqa: E402

N = 4
TIMEOUT = 240
ATOL_FWD, ATOL_GRAD = 2e-5, 2e-4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


def _devs(n=N):
    return jax.devices()[:n]


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mesh(axes):
    return TP.make_mesh(axes, device_type="cpu")


def _rank():
    import torch.distributed as dist

    return dist.get_rank()


def _placements(pls):
    """Placements as comparable tuples."""
    return tuple(("S", p.dim) if p.is_shard() else ("R",) for p in pls)


def _jax_placements(axis_names, spec):
    """A JAX PartitionSpec as the port's placements over the same axes."""
    out = []
    for name in axis_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(("S", dims[0]) if dims else ("R",))
    return tuple(out)


# -- test_mesh.py ------------------------------------------------------------

def test_axis_order_uses_short_names():
    assert TM.AXIS_ORDER == JM.AXIS_ORDER
    assert TM.AXIS_ALIASES == JM.AXIS_ALIASES
    assert "pp" in TM.AXIS_ORDER and "pipe" not in TM.AXIS_ORDER


@pytest.mark.parametrize("axes,n", [
    ({"pipe": 2, "expert": 4}, 8),
    ({"pipe": 2, "pp": 2}, 4),
    ({"data": -1, "model": -1}, 8),
    ({"model": 3, "data": -1}, 8),
    ({"data": 4, "model": 4}, 8),
    ({"data": 1}, 1),
    ({"data": -1}, 1),
    ({"model": 2, "data": -1}, 8),
])
def test_mesh_spec_resolve_matches_jax(axes, n):
    """Results and refusals (type and message) as the JAX MeshSpec's."""
    def run(spec_cls):
        try:
            return spec_cls(dict(axes)).resolve(n)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(TM.MeshSpec) == run(JM.MeshSpec)


def rank_mesh(axes):
    mesh = _mesh(axes)
    return (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape),
            tuple(mesh.get_coordinate()), _rank())


@pytest.mark.parametrize("axes", [
    {"model": 2, "pp": 2}, {"expert": 2, "pipe": 2},
    {"model": 2, "data": -1}])
def test_make_mesh_orders_axes_as_jax(pool, axes):
    jmesh = JP.make_mesh(axes, devices=_devs())
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for names, shape, coord, rank in pool.run(rank_mesh, axes,
                                              timeout=TIMEOUT):
        assert names == jmesh.axis_names
        assert dict(zip(names, shape)) == dict(jmesh.shape)
        # rank r sits where the JAX mesh puts device r
        assert ids[coord] == _devs()[rank].id


def rank_mesh_refusals():
    from tensorflowonspark_tpu_torch.utils import train as TU

    out = []
    for call in (lambda: TM.make_mesh({"data": N}),
                 lambda: TM.make_mesh({"data": N}, device_type="tpu")):
        try:
            call()
            out.append(None)
        except (TypeError, ValueError) as e:
            out.append(type(e).__name__)
    # a data parallel step refuses a mesh whose other axes would escape
    # batch norm's statistics (they span every process)
    mesh = _mesh({"data": 2, "model": 2})
    w = TP.apply_shardings({"w": torch.ones(4).requires_grad_()},
                           {"w": TP.replicated(mesh)})["w"]
    w.grad = torch.distributed.tensor.DTensor.from_local(
        torch.ones(4), mesh, w.placements)
    try:
        TU.average_gradients_([w])
        out.append(None)
    except ValueError as e:
        out.append(str(e))
    return out


def test_make_mesh_needs_device_type_and_step_needs_batch_mesh(pool):
    """``make_mesh`` builds a CPU mesh only when asked (no default device
    type), and ``utils.train.average_gradients_`` refuses a mesh with a
    non-batch axis of size > 1."""
    for typ, bad, step in pool.run(rank_mesh_refusals, timeout=TIMEOUT):
        assert (typ, bad) == ("TypeError", "ValueError")
        assert step is not None and "'model': 2" in step


FSDP_TREES = {
    "data2_fsdp2": ({"data": 2, "fsdp": 2}, {
        "tiny": (8, 8), "big": (130, 64), "odd": (65, 65)}, 2 ** 12),
    # the largest dim (102) does not divide by 4; the smaller (64) does
    "fsdp4": ({"fsdp": 4}, {"w": (102, 64)}, 1),
}


def rank_fsdp_sharding(axes, shapes, min_elems):
    mesh = _mesh(axes)
    tree = {k: torch.zeros(s) for k, s in shapes.items()}
    sh = TP.fsdp_sharding(mesh, tree, min_shard_elems=min_elems)
    return {k: _placements(v[1]) for k, v in sh.items()}


@pytest.mark.parametrize("case", sorted(FSDP_TREES))
def test_fsdp_sharding_matches_jax(pool, case):
    axes, shapes, min_elems = FSDP_TREES[case]
    jmesh = JP.make_mesh(axes, devices=_devs())
    jsh = JP.fsdp_sharding(jmesh, {k: np.zeros(s, np.float32)
                                   for k, s in shapes.items()},
                           min_shard_elems=min_elems)
    want = {k: _jax_placements(jmesh.axis_names, v.spec)
            for k, v in jsh.items()}
    for got in pool.run(rank_fsdp_sharding, axes, shapes, min_elems,
                        timeout=TIMEOUT):
        assert got == want


def rank_local_to_global(x):
    """This rank's batch (its block of ``x`` over data x fsdp) as its
    shard of the global DTensor; the assembled tensor and its spec."""
    mesh = _mesh({"data": 2, "fsdp": 2})
    local = TM.local_shard(_t(x), *TP.batch_sharding(mesh))
    g = TP.local_to_global(mesh, {"x": local}, axis=("data", "fsdp"))["x"]
    return tuple(g.shape), _placements(g.placements), _np(g.full_tensor())


def test_local_to_global_assembles_the_ranks_batches(pool):
    """Each rank's local batch becomes its shard of one global batch laid
    out over data x fsdp, as the JAX ``local_to_global`` lays out the
    processes' batches; every rank sees the whole batch, in rank order."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    jmesh = JP.make_mesh({"data": 2, "fsdp": 2}, devices=_devs())
    want_pls = _jax_placements(jmesh.axis_names, JP.batch_sharding(
        jmesh).spec)
    for shape, pls, full in pool.run(rank_local_to_global, x,
                                     timeout=TIMEOUT):
        assert shape == x.shape and pls == want_pls
        np.testing.assert_array_equal(full, x)


# -- test_ring.py ------------------------------------------------------------

def _qkv(seed, b, s, h, d):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(np.asarray(jax.random.normal(k, (b, s, h, d))) for k in ks)


def _jax_seq_fn(impl, causal):
    fns = {"ring": JP.ring_attention, "ulysses": JP.ulysses_attention,
           "zigzag": JP.zigzag_ring_attention}
    mesh = Mesh(np.array(_devs()), ("seq",))
    return shard_map(
        lambda q, k, v: fns[impl](q, k, v, "seq", causal=causal), mesh,
        in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"))


def rank_seq_attention(impl, causal, q, k, v, grads):
    """This rank's seq block of q/k/v (already zigzag-ordered for
    zigzag) through the port's scheme; with ``grads`` also the blocks of
    d(sum(out²))/d(q, k, v)."""
    mesh = _mesh({"seq": N})
    blk = TM.sharded(mesh, None, "seq")
    q, k, v = (TM.local_shard(_t(x), *blk).requires_grad_()
               for x in (q, k, v))
    fn = TR.sequence_parallel_attention(mesh, impl, causal=causal)
    out = fn(q, k, v)
    res = [_np(out)]
    if grads:
        (out ** 2).sum().backward()
        res += [_np(x.grad) for x in (q, k, v)]
    return res


def _assemble(blocks, axis=1):
    return np.concatenate(blocks, axis=axis)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses", "zigzag"])
def test_sequence_parallel_matches_jax(pool, impl, causal):
    q, k, v = _qkv(0 if impl != "zigzag" else 2, 2, 64, 4, 8)
    ref = np.asarray(jops.mha_reference(q, k, v, causal=causal))
    if impl == "zigzag":
        perm = np.asarray(JP.zigzag_permutation(64, N))
        inv = np.asarray(JP.inverse_permutation(perm))
        q, k, v = q[:, perm], k[:, perm], v[:, perm]
    want = np.asarray(jax.jit(_jax_seq_fn(impl, causal))(q, k, v))
    got = _assemble([r[0] for r in pool.run(
        rank_seq_attention, impl, causal, q, k, v, False, timeout=TIMEOUT)])
    np.testing.assert_allclose(got, want, atol=ATOL_FWD)
    if impl == "zigzag":
        got = got[:, inv]
    np.testing.assert_allclose(got, ref, atol=ATOL_FWD)


@pytest.mark.parametrize("impl", ["ring", "zigzag", "ulysses"])
def test_causal_grads_match_jax(pool, impl):
    """d(sum(out²)) for the causal schemes: the port's against the JAX
    scheme's and the reference's (``test_ring_attention_grads_match``,
    ``test_zigzag_ring_grads_match``)."""
    q, k, v = _qkv(1 if impl == "ring" else 3, 1, 32, 2 * (N // 2), 8)
    if impl == "zigzag":
        perm = np.asarray(JP.zigzag_permutation(32, N))
        inv = np.asarray(JP.inverse_permutation(perm))
    else:
        perm = inv = np.arange(32)
    fn = _jax_seq_fn(impl, True)
    want = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(fn(q[:, perm], k[:, perm], v[:, perm])
                                [:, inv] ** 2), argnums=(0, 1, 2)))(q, k, v)
    ref = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        jops.mha_reference(q, k, v, causal=True) ** 2),
        argnums=(0, 1, 2)))(q, k, v)
    ranks = pool.run(rank_seq_attention, impl, True, q[:, perm],
                     k[:, perm], v[:, perm], True, timeout=TIMEOUT)
    for i in range(3):
        got = _assemble([r[1 + i] for r in ranks])[:, inv]
        np.testing.assert_allclose(got, np.asarray(want[i]), atol=ATOL_GRAD)
        np.testing.assert_allclose(got, np.asarray(ref[i]), atol=ATOL_GRAD)


def rank_wrapper(q, k, v):
    mesh = _mesh({"data": 1, "seq": 2, "model": 2})
    blk = TM.sharded(mesh, "data", "seq", "model", None)
    call = TP.sequence_parallel_attention(mesh, "ring", causal=True)
    out = call(*(TM.local_shard(_t(x), *blk) for x in (q, k, v)))
    return tuple(mesh.get_coordinate()), _np(out)


def test_sequence_parallel_attention_wrapper(pool):
    """A data x seq x model mesh: batch, sequence and heads each split;
    the wrapper exchanges over the seq group only and returns the block
    it was given."""
    jmesh = Mesh(np.array(_devs()).reshape(1, 2, 2), ("data", "seq", "model"))
    q, k, v = _qkv(2, 2, 32, 4, 8)
    spec = NamedSharding(jmesh, P("data", "seq", "model", None))
    want = np.asarray(jax.jit(JP.sequence_parallel_attention(
        jmesh, "ring", causal=True))(*(jax.device_put(x, spec)
                                       for x in (q, k, v))))
    got = np.zeros_like(want)
    for (_, si, mi), blk in pool.run(rank_wrapper, q, k, v,
                                     timeout=TIMEOUT):
        got[:, si * 16:(si + 1) * 16, mi * 2:(mi + 1) * 2] = blk
    np.testing.assert_allclose(got, want, atol=ATOL_FWD)
    np.testing.assert_allclose(
        got, np.asarray(jops.mha_reference(q, k, v, causal=True)),
        atol=ATOL_FWD)


def test_zigzag_permutation_roundtrip():
    perm = TP.zigzag_permutation(32, 4)
    np.testing.assert_array_equal(_np(perm),
                                  np.asarray(JP.zigzag_permutation(32, 4)))
    assert _np(perm)[:8].tolist() == [0, 1, 2, 3, 28, 29, 30, 31]
    inv = TP.inverse_permutation(perm)
    np.testing.assert_array_equal(
        _np(inv), np.asarray(JP.inverse_permutation(
            JP.zigzag_permutation(32, 4))))
    x = np.arange(32)
    np.testing.assert_array_equal(x[_np(perm)][_np(inv)], x)
    with pytest.raises(ValueError, match="stripes"):
        TP.zigzag_permutation(30, 4)


LM = dict(vocab_size=64, dim=32, n_layers=2, n_heads=2, max_seq=32,
          dtype="float32")


def rank_lm_step(kw, pj, tokens, axes, impl, zigzag):
    """The port's sharded LM loss and gradients (gathered to full)."""
    cfg = TT.Config(**kw, attn_impl="reference")
    mesh = _mesh(axes)
    placed = TT.shard_params(TT.params_from_jax(pj, cfg, device="cpu"),
                             mesh, TT.param_specs(cfg, mesh=mesh))
    attn = TP.sequence_parallel_attention(mesh, impl, causal=True)
    loss = TT.mesh_value_and_grad(cfg, mesh, attn_fn=attn, zigzag=zigzag)(
        placed, _t(tokens))
    from torch.utils import _pytree as pytree

    grads = pytree.tree_map(lambda p: p.grad, placed)
    full = TT.mesh_params(grads, tuple(mesh.mesh_dim_names))
    return float(loss), pytree.tree_map(_np, full)


def _close_grad_trees(got, want, rtol, atol=0.0, scale_rel=False):
    g = jax.tree_util.tree_leaves_with_path(want)
    for path, w in g:
        a = got
        for key in path:
            a = a[key.key]
        w = np.asarray(w)
        if scale_rel:
            err = np.abs(a - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= rtol, (jax.tree_util.keystr(path), err)
        else:
            np.testing.assert_allclose(a, w, rtol=rtol, atol=atol,
                                       err_msg=jax.tree_util.keystr(path))


def test_zigzag_end_to_end_lm_training_matches_jax(pool):
    """Permuted tokens, explicit positions and labels and zigzag
    attention over 4 seq ranks give the contiguous unsharded loss and
    gradients (the JAX package's ``test_zigzag_end_to_end_lm_training_
    matches``), and the JAX zigzag path's."""
    jcfg = JT.Config(**LM, attn_impl="reference")
    pj = jax.tree_util.tree_map(np.asarray,
                                JT.init(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(0).integers(0, 64, (2, 32)).astype(
        np.int32)
    base_loss, base_grads = jax.jit(jax.value_and_grad(
        lambda p, t: JT.loss_fn(p, t, jcfg)))(pj, tokens)
    jmesh = Mesh(np.array(_devs()).reshape(1, 4, 1), ("data", "seq", "model"))
    perm = JP.zigzag_permutation(32, 4)
    toks_p, labels_p, positions = JT.zigzag_lm_batch(tokens, perm)
    zz = JP.sequence_parallel_attention(jmesh, "zigzag", causal=True)
    zz_loss = jax.jit(lambda p, t: JT.loss_fn(
        p, t, jcfg, attn_fn=zz, labels=labels_p, positions=positions))(
        pj, toks_p)
    for loss, grads in pool.run(rank_lm_step, LM, pj, tokens,
                                {"data": 1, "seq": 4, "model": 1}, "zigzag",
                                True, timeout=TIMEOUT):
        np.testing.assert_allclose(loss, float(base_loss), rtol=1e-5)
        np.testing.assert_allclose(loss, float(zz_loss), rtol=1e-5)
        _close_grad_trees(grads, base_grads, rtol=1e-4, atol=1e-5)


def test_zigzag_lm_batch_matches_jax():
    tokens = np.random.default_rng(1).integers(0, 64, (2, 16))
    perm = TP.zigzag_permutation(16, 2)
    got = TT.zigzag_lm_batch(tokens, perm)
    want = JT.zigzag_lm_batch(jnp.asarray(tokens), jnp.asarray(_np(perm)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


TP_LM = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, max_seq=32,
             dtype="float32")


def test_param_specs_tp2_matches_unsharded_jax(pool):
    """Megatron's plan over model=2 (q, k and v split by heads, the
    vocab-parallel head gathered) with fsdp=2: the loss and every
    gradient of the unsharded JAX ``loss_fn``."""
    jcfg = JT.Config(**TP_LM, attn_impl="reference")
    pj = jax.tree_util.tree_map(np.asarray,
                                JT.init(jax.random.PRNGKey(4), jcfg))
    tokens = np.random.default_rng(4).integers(0, 64, (4, 32)).astype(
        np.int32)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, t: JT.loss_fn(p, t, jcfg)))(pj, tokens)
    for loss, grads in pool.run(rank_lm_step, TP_LM, pj, tokens,
                                {"fsdp": 2, "model": 2}, "ring", False,
                                timeout=TIMEOUT):
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
        _close_grad_trees(grads, want, rtol=1e-4, scale_rel=True)


def test_param_specs_match_jax_plan():
    """The plan's axes per leaf are the JAX ``param_specs``' (wqkv's on
    its [L, D, 3, D] view: the model axis on the per-head dim)."""
    cfg = TT.Config(**TP_LM)
    got = TT.param_specs(cfg)
    want = JT.param_specs(JT.Config(**TP_LM))
    for name in ("embed", "ln_f", "head"):
        assert got[name] == tuple(want[name])
    for name, spec in want["layers"].items():
        if name == "wqkv":
            assert got["layers"][name] == (None, "fsdp", None, "model")
        else:
            assert got["layers"][name] == tuple(spec)


# -- test_pp_moe.py ----------------------------------------------------------

def _stages(seed, n, dim):
    ks = jax.random.split(jax.random.PRNGKey(seed), n)
    return [{"w": (np.asarray(jax.random.normal(k, (dim, dim)))
                   / np.sqrt(dim)).astype(np.float32),
             "b": np.zeros((dim,), np.float32)} for k in ks]


def _stage_fn_j(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stage_fn_t(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def rank_pipeline(stages, x, n_stages, n_micro, grads):
    mesh = _mesh({"pp": n_stages, "data": N // n_stages})
    stacked = TP.stack_stage_params([{k: _t(v) for k, v in s.items()}
                                     for s in stages])
    placed = TP.apply_shardings(
        {k: v.requires_grad_() for k, v in stacked.items()},
        TP.stage_sharding(mesh, stacked))
    y = TP.pipeline_apply(_stage_fn_t, placed, _t(x), mesh=mesh,
                          n_microbatches=n_micro)
    out = {"y": _np(y), "stage": mesh.get_coordinate()[0]}
    if grads:
        (y ** 2).sum().backward()
        out["grads"] = {k: _np(v.grad.to_local()) for k, v in placed.items()}
    return out


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 8)])
def test_pipeline_matches_jax(pool, n_stages, n_micro):
    dim, batch = 16, 16
    stages = _stages(0, n_stages, dim)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (batch, dim)))
    ref = x
    for p in stages:
        ref = _stage_fn_j(p, ref)
    jmesh = Mesh(np.array(_devs(n_stages)), ("pp",))
    stacked = JP.stack_stage_params(stages)
    stacked = jax.device_put(stacked, JP.stage_sharding(jmesh, stacked))
    want = np.asarray(jax.jit(lambda sp, x: JP.pipeline_apply(
        _stage_fn_j, sp, x, mesh=jmesh, n_microbatches=n_micro))(stacked, x))
    for r in pool.run(rank_pipeline, stages, x, n_stages, n_micro, False,
                      timeout=TIMEOUT):
        np.testing.assert_allclose(r["y"], want, atol=1e-5)
        np.testing.assert_allclose(r["y"], np.asarray(ref), atol=1e-5)


def test_pipeline_is_differentiable_matches_jax(pool):
    dim = 8
    stages = _stages(0, 2, dim)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, dim)))
    jmesh = Mesh(np.array(_devs(2)), ("pp",))
    stacked = JP.stack_stage_params(stages)
    want = jax.jit(jax.grad(lambda sp, x: jnp.sum(JP.pipeline_apply(
        _stage_fn_j, sp, x, mesh=jmesh, n_microbatches=4) ** 2)))(
        stacked, x)

    def loss_seq(sp, x):
        y = x
        for i in range(2):
            y = _stage_fn_j(jax.tree.map(lambda p: p[i], sp), y)
        return jnp.sum(y ** 2)

    ref = jax.grad(loss_seq)(stacked, x)
    for r in pool.run(rank_pipeline, stages, x, 2, 4, True,
                      timeout=TIMEOUT):
        i = r["stage"]
        for k in ("w", "b"):
            np.testing.assert_allclose(r["grads"][k][0],
                                       np.asarray(want[k][i]), atol=1e-4)
            np.testing.assert_allclose(r["grads"][k][0],
                                       np.asarray(ref[k][i]), atol=1e-4)


def _moe_params(seed, dim, hidden, experts):
    return jax.tree_util.tree_map(np.asarray, JMOE.init(
        jax.random.PRNGKey(seed), dim=dim, hidden=hidden,
        num_experts=experts))


def test_moe_forward_balance_loss_and_grads_match_jax():
    pj = _moe_params(0, 16, 32, 4)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 8, 16)))
    y, aux = JMOE.apply(pj, x)
    pt = {k: v.requires_grad_() for k, v in
          MOE.params_from_jax(pj, device="cpu").items()}
    yt, auxt = MOE.apply(pt, _t(x))
    np.testing.assert_allclose(_np(yt), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(float(auxt.detach()), float(aux),
                               rtol=1e-5)
    assert float(auxt.detach()) > 0
    want = jax.grad(lambda p: jnp.sum(JMOE.apply(p, x)[0] ** 2)
                    + JMOE.apply(p, x)[1])(pj)
    ((yt ** 2).sum() + auxt).backward()
    for k in ("router", "w1", "w2"):
        assert float(pt[k].grad.abs().sum()) > 0
        np.testing.assert_allclose(_np(pt[k].grad), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)


def test_moe_param_specs_match_jax():
    for kw in (dict(ep_axis="model"), dict(ep_axis="ep", fsdp_axis="fsdp")):
        want = JMOE.param_specs(**kw)
        got = MOE.param_specs(**kw)
        assert {k: tuple(v) for k, v in want.items()} == got


def rank_moe_ep(pj, x):
    """Experts split over ``model`` (ep), the batch over ``data``; y of
    this rank's rows and d(sum(y²)) of its experts, summed over data."""
    import torch.distributed as dist

    mesh = _mesh({"data": 2, "model": 2})
    specs = MOE.param_specs(ep_axis="model")
    placed = TP.apply_shardings(
        {k: _t(v).requires_grad_() for k, v in pj.items()},
        {k: TM.sharded(mesh, *s) for k, s in specs.items()})
    xl = TM.local_shard(_t(x), *TM.sharded(mesh, "data"))
    y, _ = MOE.apply({k: v.to_local() for k, v in placed.items()}, xl,
                     ep_group=mesh.get_group("model"))
    (y ** 2).sum().backward()
    grads = {}
    for k, v in placed.items():
        g = v.grad.to_local().clone()
        dist.all_reduce(g, group=mesh.get_group("data"))
        grads[k] = _np(g)
    return tuple(mesh.get_coordinate()), _np(y), grads


def test_moe_expert_sharded_on_mesh_matches_jax(pool):
    jmesh = Mesh(np.array(_devs()).reshape(2, 2), ("data", "model"))
    pj = _moe_params(0, 16, 64, 8)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 8, 16)))
    specs = jax.tree.map(lambda s: NamedSharding(jmesh, s),
                         JMOE.param_specs(ep_axis="model"),
                         is_leaf=lambda s: isinstance(s, P))
    sharded = jax.device_put(pj, specs)
    xs = jax.device_put(x, NamedSharding(jmesh, P("data")))
    want = np.asarray(jax.jit(JMOE.apply)(sharded, xs)[0])
    ref, _ = JMOE.apply(pj, x)
    wgrad = jax.grad(lambda p: jnp.sum(JMOE.apply(p, x)[0] ** 2))(pj)
    got = np.zeros_like(want)
    for (di, mi), y, grads in pool.run(rank_moe_ep, pj, x,
                                       timeout=TIMEOUT):
        got[di * 2:(di + 1) * 2] = y
        np.testing.assert_allclose(grads["router"],
                                   np.asarray(wgrad["router"]), atol=1e-4)
        for k in ("w1", "w2"):
            np.testing.assert_allclose(
                grads[k], np.asarray(wgrad[k])[mi * 4:(mi + 1) * 4],
                atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


# -- fsdp train state: shard_train_state and the ResNet step -----------------

R18 = dict(depth=18, small_inputs=True)


def rank_fsdp_resnet(pj, sj, images, labels):
    """``shard_train_state`` on data=2 x fsdp=2, one SGD-momentum step of
    ``resnet.make_train_step`` on the placed params: gathered for the
    forward, gradients reduce-scattered and averaged, BN over the global
    batch.  Returns the shardings, the rank's loss, the gathered new
    params and the state."""
    from torch.utils import _pytree as pytree

    mesh = _mesh({"data": 2, "fsdp": 2})
    params, state = R.params_from_jax(pj, sj, device="cpu")
    (params, state, _), (p_sh, s_sh, _) = TP.shard_train_state(
        mesh, params, state)
    state = TS.local_tree(state)
    step = R.make_train_step(
        torch.optim.SGD(R.param_leaves(params), lr=0.1, momentum=0.9),
        compute_dtype=torch.float32, **R18)
    bsh = TP.batch_sharding(mesh)
    loss, _, new_state = step(params, state,
                              TM.local_shard(_t(images), *bsh),
                              TM.local_shard(_t(labels), *bsh))
    full = TS.gather_params(params, ("data", "fsdp"))
    new_p, new_s = R.params_to_jax(
        pytree.tree_map(torch.Tensor.detach, full),
        pytree.tree_map(torch.Tensor.detach, new_state))
    # the size of the dim each leaf is sharded on (None: replicated);
    # the port's kernels are OIHW where JAX's are HWIO
    shapes = dict(C._flatten_leaves(full))
    sharded_sizes = {}
    for path, (_, pls) in C._flatten_leaves(p_sh):
        dims = [p.dim for p in pls if p.is_shard()]
        sharded_sizes[path] = shapes[path].shape[dims[0]] if dims else None
    return sharded_sizes, float(loss.detach()), new_p, new_s


def test_shard_train_state_resnet_step_matches_jax(pool):
    """The JAX ``shard_train_state`` layout (fsdp params, replicated BN
    state) and a step jitted over it, against the port's on 4 ranks:
    the same leaves sharded, each on a dim of the same size (the port's
    conv kernels are OIHW, JAX's HWIO, so where two dims have the
    largest size the rule's first pick may be the other of the two), and
    the same loss, new params and new state.""" 
    import test_torch_sync_bn as SB

    # tests/test_torch_sync_bn.py's ResNet-18 (width 16) and batch
    pj, sj, images, labels = SB._resnet_data()
    labels = labels.astype(np.int64)
    jmesh = JP.make_mesh({"data": 2, "fsdp": 2}, devices=_devs())
    opt = optax.sgd(0.1, momentum=0.9)
    (jp, js, jo), (p_sh, s_sh, o_sh) = JP.shard_train_state(
        jmesh, pj, sj, opt.init(pj))
    bsh = JP.batch_sharding(jmesh)
    step = jax.jit(JR.make_train_step(opt, compute_dtype=jnp.float32, **R18),
                   in_shardings=(p_sh, s_sh, o_sh, bsh, bsh),
                   out_shardings=(p_sh, s_sh, o_sh, None, None))
    jp, js, _, jloss, _ = step(jp, js, jo, images, labels.astype(np.int32))
    jp, js = (jax.tree_util.tree_map(np.asarray, t) for t in (jp, js))
    want_sh = {}
    for path, leaf in C._flatten_leaves(pj):
        spec = dict(C._flatten_leaves(jax.tree_util.tree_map(
            lambda x: x.spec, p_sh)))[path]
        dims = [d for d, e in enumerate(spec) if e is not None]
        want_sh[path] = leaf.shape[dims[0]] if dims else None
    ranks = pool.run(rank_fsdp_resnet, pj, sj, images, labels,
                     timeout=TIMEOUT)
    loss = np.mean([r[1] for r in ranks])
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    for sh, _, params, state in ranks:
        assert sh == want_sh
        SB._close_trees(params, jp, "params", bn_rtol=SB.BN_PARAM_RTOL)
        SB._close_trees(state, js, "state")


# -- restore_any(target_shardings=) ------------------------------------------

def rank_restore(d):
    mesh = _mesh({"data": 2, "fsdp": 2})
    tree, step = C.restore_any(
        d, target_shardings=lambda t: TP.fsdp_sharding(mesh, t))
    return step, {k: (_np(v.to_local()), _placements(v.placements))
                  for k, v in tree["params"].items()}


def test_restore_any_places_like_jax(pool, tmp_path):
    """A checkpoint restored onto data=2 x fsdp=2 by ``fsdp_sharding``:
    rank r holds the block that JAX's placed restore puts on device r."""
    d = str(tmp_path)
    tree = {"params": {"big": np.arange(130 * 64, dtype=np.float32)
                       .reshape(130, 64), "tiny": np.ones((4, 4),
                                                          np.float32)}}
    JC.save_checkpoint(d, tree, 7)
    jmesh = JP.make_mesh({"data": 2, "fsdp": 2}, devices=_devs())
    jtree, jstep = JC.restore_any(
        d, target_shardings=lambda t: JP.fsdp_sharding(jmesh, t))
    for rank, (step, leaves) in enumerate(pool.run(rank_restore, d,
                                                   timeout=TIMEOUT)):
        assert step == jstep == 7
        for k, (block, pls) in leaves.items():
            arr = jtree["params"][k]
            shard = [s for s in arr.addressable_shards
                     if s.device.id == _devs()[rank].id][0]
            np.testing.assert_array_equal(block, np.asarray(shard.data))
            assert pls == _jax_placements(jmesh.axis_names,
                                          arr.sharding.spec)
