"""PyTorch port, ``models/resnet.py`` against the JAX package's on the
same params (converted by ``resnet.params_from_jax``) and the same numpy
images (CPU): ``apply``'s logits and new BN state in training and eval
mode, ResNet-20 (CIFAR stem) at 32x32, ResNet-18 at 64x64 with both
stems and the SAME max pool, ResNet-50 at 64x64 for the bottleneck
blocks; loss, every gradient and two SGD-momentum steps against
``resnet.make_train_step(optax.sgd(0.1, momentum=0.9))``; ``remat``,
``accum_steps``, ``bn_fused``; ``flops_per_image``; one bf16 step.

Tolerances, relative to each tensor's largest value (worst measured in
brackets):
- eval mode, float32: ``EVAL_RTOL`` 1e-5 (1.5e-6);
- training mode, float32: BN normalises with batch statistics over few
  samples a channel, so float32 rounding on either side grows.  Against
  the port run in float64, the JAX package's float32 logits and states
  are off by up to 1.4e-5 (depth 18/20) and 2.8e-4 (depth 50, batch 2),
  the port's by up to 1.1e-5 and 1.2e-4.  So ``TRAIN_RTOL`` 2e-4 at
  depth 18/20 (3.5e-5) and ``R50_TRAIN_RTOL`` 2e-3 for ResNet-50's
  forward (2.8e-4).  The gradients of BN's scale and bias are sums over
  every position of terms that nearly cancel: the JAX package's float32
  sums land up to 1.2e-2 off a float64 evaluation of the port (the
  port's 5e-6), so ``BN_GRAD_RTOL`` 2e-2 for those leaves (6.7e-5 at the
  first step), and for every param after a second step, whose gradient
  is taken at params that already differ by that much (1.3e-2).  A
  layout, padding, stem or statistics fault moves values by O(1) of
  their size;
- bf16: ``BF16_RTOL`` 5e-2 on the loss and the BN state (2.8e-2; both
  sides round each op's output to bf16, in different places), which
  still fails a wrong layer by far.

ReLU's gradient jumps at 0: a pre-activation within float32 rounding of
0 can take opposite branches in the two packages, and one such element
moves the gradients upstream of it by a few percent (seen on other
inputs: 4.3e-2 on a conv kernel).  Both answers are right, so the
gradient tests first assert that their inputs hold no pre-activation
within 1e-6 of its layer's largest magnitude (exact zeros are ties,
which both packages give 1/2, and stay) where they compare at
``TRAIN_RTOL``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tensorflowonspark_tpu.models import layers as JL  # noqa: E402
from tensorflowonspark_tpu.models import resnet as JR  # noqa: E402
from tensorflowonspark_tpu_torch.models import layers as L  # noqa: E402
from tensorflowonspark_tpu_torch.models import resnet as R  # noqa: E402
from tensorflowonspark_tpu_torch.utils import train as TU  # noqa: E402
from tensorflowonspark_tpu_torch.utils.checkpoint import (  # noqa: E402
    tree_leaves,
)

EVAL_RTOL = 1e-5
TRAIN_RTOL = 2e-4
BN_GRAD_RTOL = 2e-2
R50_TRAIN_RTOL = 2e-3
BF16_RTOL = 5e-2

# name -> (depth, small_inputs, image side, width, batch, data seed)
CONFIGS = {
    "cifar20": (20, True, 32, 8, 2, 0),
    "r18": (18, False, 64, 8, 4, 1),
    "r50": (50, False, 64, 16, 2, 50),
}
NEAR_TIE = 1e-6


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _close(got, ref, what, rtol):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), (what, err)


def _items(tree, prefix=""):
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _items(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _close_trees(got, ref, what, rtol, bn_rtol=None):
    """Every leaf within ``rtol``; BN ``scale``/``bias`` leaves within
    ``bn_rtol`` where given."""
    g, r = _items(got), _items(ref)
    assert [p for p, _ in g] == [p for p, _ in r], what
    for (path, a), (_, b) in zip(g, r):
        leaf = path.rsplit("/", 1)[-1]
        tol = bn_rtol if bn_rtol and leaf in ("scale", "bias") else rtol
        _close(a, b, f"{what} {path}", tol)


@pytest.fixture(scope="module")
def nets():
    """name -> (JAX params, JAX state, images, labels), made once."""
    out = {}
    for name, (depth, small, size, width, batch, seed) in CONFIGS.items():
        pj, sj = jax.jit(lambda k: JR.init(
            k, depth=depth, num_classes=10, width=width,
            small_inputs=small))(jax.random.PRNGKey(0))
        rng = np.random.default_rng(seed)
        if small:   # CIFAR records are f32 in [0, 1)
            images = rng.random((batch, size, size, 3), dtype=np.float32)
        else:       # ImageNet records are uint8, not normalised
            images = rng.integers(0, 256, (batch, size, size, 3),
                                  dtype=np.uint8)
        labels = rng.integers(0, 10, batch).astype(np.int64)
        out[name] = (pj, sj, images, labels)
    return out


def _assert_no_near_ties(monkeypatch, pt, st, images, depth, small):
    """No ReLU input of the port's forward lies within ``NEAR_TIE`` of
    its layer's largest magnitude without being exactly 0 (the unfused
    path computes the same pre-activations and calls ``layers.relu``)."""
    near = []
    relu = L.relu

    def spy(x):
        m = x.detach().abs()
        near.append(int(((m > 0) & (m < NEAR_TIE * m.max())).sum()))
        return relu(x)

    monkeypatch.setattr(L, "relu", spy)
    with torch.no_grad():
        R.apply(pt, st, torch.from_numpy(images), depth=depth,
                small_inputs=small, compute_dtype=torch.float32,
                bn_fused=False)
    monkeypatch.setattr(L, "relu", relu)
    assert near and sum(near) == 0, ("near-tie pre-activations", near)


def _torch_net(pj, sj):
    pt, st = R.params_from_jax(pj, sj, device="cpu")
    for p in R.param_leaves(pt):
        p.requires_grad_()
    return pt, st


def test_params_round_trip_and_layout(nets):
    pj, sj, _, _ = nets["r18"]
    pt, st = R.params_from_jax(pj, sj, device="cpu")
    assert tuple(pt["stem"]["w"].shape) == (8, 3, 7, 7)
    assert tuple(pt["s1b0"]["conv1"]["w"].shape) == (16, 8, 3, 3)
    assert tuple(pt["fc"]["w"].shape) == (64, 10)
    np.testing.assert_array_equal(_np(pt["s1b0"]["conv1"]["w"][5, 7]),
                                  np.asarray(pj["s1b0"]["conv1"]["w"])
                                  [:, :, 7, 5])
    back_p, back_s = R.params_to_jax(pt, st)
    for a, b in zip(tree_leaves(back_p) + tree_leaves(back_s),
                    tree_leaves(pj) + tree_leaves(sj)):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    own_p, own_s = R.init(torch.Generator().manual_seed(0), depth=18,
                          num_classes=10, width=8)
    shapes = [tuple(x.shape) for x in tree_leaves(own_p) + tree_leaves(own_s)]
    assert shapes == [tuple(x.shape) for x in tree_leaves(pt)
                      + tree_leaves(st)]
    assert R.params_to_jax(own_p)[1] is None


def test_entry_points_default_to_the_card(nets):
    pj, sj, _, _ = nets["cifar20"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.params_from_jax(pj, sj)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name,stem_s2d", [
    ("cifar20", True), ("r18", True), ("r18", False), ("r50", True)])
def test_apply_matches_jax(nets, name, stem_s2d, train):
    depth, small = CONFIGS[name][:2]
    pj, sj, images, _ = nets[name]
    ref, ref_state = jax.jit(
        lambda p, s, x: JR.apply(p, s, x, depth=depth, train=train,
                                 small_inputs=small,
                                 compute_dtype=jnp.float32,
                                 stem_s2d=stem_s2d))(pj, sj,
                                                     jnp.asarray(images))
    pt, st = R.params_from_jax(pj, sj, device="cpu")
    with torch.no_grad():
        logits, new_state = R.apply(pt, st, torch.from_numpy(images),
                                    depth=depth, train=train,
                                    small_inputs=small,
                                    compute_dtype=torch.float32,
                                    stem_s2d=stem_s2d)
    rtol = (EVAL_RTOL if not train else
            R50_TRAIN_RTOL if depth == 50 else TRAIN_RTOL)
    assert logits.dtype == torch.float32
    _close(logits, ref, "logits", rtol)
    _close_trees(new_state, ref_state, "state", rtol)
    if not train:
        assert new_state is not st and \
            tree_leaves(new_state)[0] is tree_leaves(st)[0]


def test_stem_space_to_depth_equals_the_7x7_stem():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 3, 32, 30))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 3, 7, 7))
                         .astype(np.float32) * 0.1)
    ref = L.conv({"w": w}, x, stride=2)
    got = R._stem_space_to_depth(w, x)
    _close(got, ref, "s2d stem", EVAL_RTOL)


def _jax_loss_and_grads(pj, sj, images, labels, depth, small):
    def loss(p):
        logits, new_state = JR.apply(p, sj, images, depth=depth, train=True,
                                     small_inputs=small,
                                     compute_dtype=jnp.float32)
        return JL.softmax_cross_entropy(logits, labels), new_state

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(pj)


@pytest.mark.parametrize("name", ["cifar20", "r18"])
def test_loss_grads_and_sgd_steps_match_optax(nets, name, monkeypatch):
    """The loss and every gradient of one step, then two steps of
    ``make_train_step`` with ``torch.optim.SGD(0.1, momentum=0.9)``
    against ``optax.sgd(0.1, momentum=0.9)``: losses, accuracies, BN
    state and params (the second step is the first momentum moves)."""
    depth, small = CONFIGS[name][:2]
    pj, sj, images, labels = nets[name]
    ji, jl = jnp.asarray(images), jnp.asarray(labels, jnp.int32)
    (ref_loss, _), ref_grads = _jax_loss_and_grads(pj, sj, ji, jl, depth,
                                                   small)
    pt, st = _torch_net(pj, sj)
    _assert_no_near_ties(monkeypatch, pt, st, images, depth, small)

    def loss_fn(p):
        logits, _ = R.apply(p, st, torch.from_numpy(images), depth=depth,
                            small_inputs=small, compute_dtype=torch.float32)
        return L.softmax_cross_entropy(logits, torch.from_numpy(labels))

    loss, grads = TU.value_and_grad(loss_fn)(pt)
    _close(loss, ref_loss, "loss", TRAIN_RTOL)
    _close_trees(R.params_to_jax(grads)[0], ref_grads, "grads", TRAIN_RTOL,
                 BN_GRAD_RTOL)

    opt = optax.sgd(0.1, momentum=0.9)
    jstep = jax.jit(JR.make_train_step(opt, depth=depth, small_inputs=small,
                                       compute_dtype=jnp.float32))
    ostate = opt.init(pj)
    tstep = R.make_train_step(
        torch.optim.SGD(R.param_leaves(pt), lr=0.1, momentum=0.9),
        depth=depth, small_inputs=small, compute_dtype=torch.float32)
    jp, js = pj, sj
    for i in range(2):
        jp, js, ostate, ref_loss, ref_acc = jstep(jp, js, ostate, ji, jl)
        loss, acc, st = tstep(pt, st, torch.from_numpy(images),
                              torch.from_numpy(labels))
        _close(loss, ref_loss, f"loss {i}", TRAIN_RTOL)
        assert float(acc) == float(ref_acc)
        assert not any(t.requires_grad for t in tree_leaves(st))
        # step 2's gradient is taken at params that already differ by the
        # BN gradients' rounding (up to BN_GRAD_RTOL of those leaves), so
        # after it every leaf is held to that tolerance; momentum moves
        # each param by ~0.9·lr·g there, far more
        rtol = TRAIN_RTOL if i == 0 else BN_GRAD_RTOL
        _close_trees(R.params_to_jax(pt)[0], jp, f"params after step {i}",
                     rtol, BN_GRAD_RTOL)
        _close_trees(st, js, f"state after step {i}", rtol)


def _port_step(nets, name, steps=1, **kw):
    depth, small = CONFIGS[name][:2]
    pj, sj, images, labels = nets[name]
    pt, st = _torch_net(pj, sj)
    step = R.make_train_step(
        torch.optim.SGD(R.param_leaves(pt), lr=0.1, momentum=0.9),
        depth=depth, small_inputs=small, compute_dtype=torch.float32, **kw)
    losses = []
    for _ in range(steps):
        loss, _, st = step(pt, st, torch.from_numpy(images),
                           torch.from_numpy(labels))
        losses.append(float(loss))
    return losses, pt, st


def test_remat_and_unfused_bn_equal_the_plain_step(nets):
    """``remat=True`` recomputes the same forward, and ``bn_fused=False``
    is autograd over the same forward: two steps give the plain step's
    losses, params and state (float32 summation order only)."""
    base = _port_step(nets, "r18", steps=2)
    for kw in (dict(remat=True), dict(bn_fused=False)):
        other = _port_step(nets, "r18", steps=2, **kw)
        np.testing.assert_allclose(other[0], base[0], rtol=1e-5)
        _close_trees(other[1], base[1], f"params {kw}", 1e-5)
        _close_trees(other[2], base[2], f"state {kw}", 1e-5)


def test_accum_steps_match_jax(nets, monkeypatch):
    """Two microbatches of one image: the mean loss, the state advanced
    twice, the last microbatch's accuracy, and the params after the
    step."""
    depth, small = CONFIGS["cifar20"][:2]
    pj, sj, images, labels = nets["cifar20"]
    opt = optax.sgd(0.1, momentum=0.9)
    jstep = jax.jit(JR.make_train_step(opt, depth=depth, small_inputs=small,
                                       compute_dtype=jnp.float32,
                                       accum_steps=2))
    jp, js, _, ref_loss, ref_acc = jstep(pj, sj, opt.init(pj),
                                         jnp.asarray(images),
                                         jnp.asarray(labels, jnp.int32))
    pt, st = _torch_net(pj, sj)
    for half in (images[:1], images[1:]):
        _assert_no_near_ties(monkeypatch, pt, st, half, depth, small)
    step = R.make_train_step(
        torch.optim.SGD(R.param_leaves(pt), lr=0.1, momentum=0.9),
        depth=depth, small_inputs=small, compute_dtype=torch.float32,
        accum_steps=2)
    loss, acc, st = step(pt, st, torch.from_numpy(images),
                         torch.from_numpy(labels))
    _close(loss, ref_loss, "loss", TRAIN_RTOL)
    assert float(acc) == float(ref_acc)
    _close_trees(st, js, "state", TRAIN_RTOL)
    _close_trees(R.params_to_jax(pt)[0], jp, "params", TRAIN_RTOL,
                 BN_GRAD_RTOL)


def test_bf16_step_matches_jax(nets):
    """One bf16 step (f32 masters and BN statistics): its loss and the
    BN state it leaves, within ``BF16_RTOL``; params and state stay
    f32.  (A second step is no test: on a batch of 4 at lr 0.1 the
    first step's bf16 roundings already move the next loss by O(1).)"""
    depth, small = CONFIGS["r18"][:2]
    pj, sj, images, labels = nets["r18"]
    opt = optax.sgd(0.1, momentum=0.9)
    jstep = jax.jit(JR.make_train_step(opt, depth=depth, small_inputs=small,
                                       compute_dtype=jnp.bfloat16))
    _, js, _, ref_loss, _ = jstep(pj, sj, opt.init(pj), jnp.asarray(images),
                                  jnp.asarray(labels, jnp.int32))
    pt, st = _torch_net(pj, sj)
    step = R.make_train_step(
        torch.optim.SGD(R.param_leaves(pt), lr=0.1, momentum=0.9),
        depth=depth, small_inputs=small, compute_dtype=torch.bfloat16)
    loss, _, st = step(pt, st, torch.from_numpy(images),
                       torch.from_numpy(labels))
    assert all(t.dtype == torch.float32 for t in tree_leaves(st))
    assert all(p.dtype == torch.float32 for p in R.param_leaves(pt))
    _close(loss, ref_loss, "bf16 loss", BF16_RTOL)
    _close_trees(st, js, "bf16 state", BF16_RTOL)


@pytest.mark.parametrize("depth", sorted(R._PLANS))
def test_flops_per_image_matches_jax(depth):
    for size in (32, 64, 224):
        assert R.flops_per_image(depth, size) == \
            JR.flops_per_image(depth, size)
    assert R._PLANS[depth] == JR._PLANS[depth]
