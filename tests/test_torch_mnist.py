"""PyTorch port, the MNIST model: ``apply``, ``loss_fn``, every gradient
and one SGD-momentum step against the JAX package's ``models/mnist.py``
and ``optax.sgd`` on the same params (converted by
``mnist.params_from_jax``) and the same numpy images (CPU, float32).

Tolerance 1e-5 relative to each tensor's largest value: both sides
compute in f32 and differ only in the order of the convolutions' and
products' sums (~1e-7 relative each).  A layout fault (an HWIO kernel
read as OIHW, fc1 fed NCHW-ordered features) moves values by O(1).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tensorflowonspark_tpu.models import layers as JL  # noqa: E402
from tensorflowonspark_tpu.models import mnist as JM  # noqa: E402
from tensorflowonspark_tpu_torch.examples import mnist_spark  # noqa: E402
from tensorflowonspark_tpu_torch.models import layers as L  # noqa: E402
from tensorflowonspark_tpu_torch.models import mnist as M  # noqa: E402

RTOL = 1e-5


def _close(got, ref, what):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= RTOL * max(np.abs(ref).max(), 1e-30), (what, err)


@pytest.fixture(scope="module")
def model():
    pj = JM.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, pj)
    images, labels = mnist_spark.collate(mnist_spark.synthetic_records(16))
    return pj, tree, images, labels


def _torch_params(tree, grad=False):
    pt = M.params_from_jax(tree, device="cpu")
    if grad:
        for layer in pt.values():
            for v in layer.values():
                v.requires_grad_()
    return pt


def test_params_from_jax_transposes_conv_kernels(model):
    _, tree, _, _ = model
    pt = _torch_params(tree)
    assert tuple(pt["conv1"]["w"].shape) == (32, 1, 3, 3)
    assert tuple(pt["conv2"]["w"].shape) == (64, 32, 3, 3)
    assert tuple(pt["fc1"]["w"].shape) == (3136, 128)
    np.testing.assert_array_equal(pt["conv2"]["w"][5, 7].numpy(),
                                  tree["conv2"]["w"][:, :, 7, 5])
    own = M.init_params(torch.Generator().manual_seed(0))
    assert {k: {kk: tuple(vv.shape) for kk, vv in v.items()}
            for k, v in own.items()} == \
        {k: {kk: tuple(vv.shape) for kk, vv in v.items()}
         for k, v in pt.items()}


def test_layers_match_jax():
    """SAME 3x3 conv (NCHW/OIHW against NHWC/HWIO) at strides 1 and 2,
    2x2 VALID max pool on an odd size (the edge row is dropped), dense,
    cross entropy."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 9, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    ref = JL.conv({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = L.conv({"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                  "b": torch.from_numpy(b)},
                 torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), ref, "conv")
    _close(L.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
           .permute(0, 2, 3, 1), JL.max_pool(jnp.asarray(x)), "max_pool")
    dw = rng.standard_normal((3, 5)).astype(np.float32)
    db = rng.standard_normal(5).astype(np.float32)
    h = rng.standard_normal((4, 3)).astype(np.float32)
    _close(L.dense({"w": torch.from_numpy(dw), "b": torch.from_numpy(db)},
                   torch.from_numpy(h)),
           JL.dense({"w": jnp.asarray(dw), "b": jnp.asarray(db)},
                    jnp.asarray(h)), "dense")
    logits = rng.standard_normal((6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 6)
    _close(L.softmax_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels)),
           JL.softmax_cross_entropy(jnp.asarray(logits),
                                    jnp.asarray(labels)), "ce")
    # SAME at stride 2 pads XLA's way, (0, 1) on a side of 8
    w2 = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    x2 = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    _close(L.conv({"w": torch.from_numpy(w2.transpose(3, 2, 0, 1).copy())},
                  torch.from_numpy(x2).permute(0, 3, 1, 2), stride=2)
           .permute(0, 2, 3, 1),
           JL.conv({"w": jnp.asarray(w2)}, jnp.asarray(x2), stride=2),
           "conv stride 2")


def test_apply_loss_and_grads_match_jax(model):
    pj, tree, images, labels = model
    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(
        JM.loss_fn, has_aux=True)(pj, jnp.asarray(images),
                                  jnp.asarray(labels, jnp.int32))
    pt = _torch_params(tree, grad=True)
    loss, logits = M.loss_fn(pt, torch.from_numpy(images),
                             torch.from_numpy(labels))
    _close(logits, ref_logits, "logits")
    _close(loss, ref_loss, "loss")
    loss.backward()
    for name, layer in pt.items():
        for k, v in layer.items():
            ref = np.asarray(ref_grads[name][k])
            if name.startswith("conv") and k == "w":
                ref = ref.transpose(3, 2, 0, 1)
            _close(v.grad, ref, f"grad {name}.{k}")


def test_sgd_momentum_steps_match_optax(model):
    """Two ``make_train_step`` steps with ``torch.optim.SGD(0.05,
    momentum=0.9)`` against ``optax.sgd(0.05, momentum=0.9)`` (the
    second step is the first that momentum moves)."""
    pj, tree, images, labels = model
    opt = optax.sgd(0.05, momentum=0.9)
    state = opt.init(pj)
    jstep = jax.jit(JM.make_train_step(opt))
    pt = _torch_params(tree, grad=True)
    leaves = [v for layer in pt.values() for v in layer.values()]
    tstep = M.make_train_step(torch.optim.SGD(leaves, lr=0.05, momentum=0.9))
    for i in range(2):
        sl = slice(8 * i, 8 * i + 8)
        pj, state, ref_loss, ref_acc = jstep(
            pj, state, jnp.asarray(images[sl]),
            jnp.asarray(labels[sl], jnp.int32))
        loss, acc = tstep(pt, torch.from_numpy(images[sl]),
                          torch.from_numpy(labels[sl]))
        _close(loss, ref_loss, f"loss {i}")
        assert float(acc) == float(ref_acc)
    for name, layer in pt.items():
        for k, v in layer.items():
            ref = np.asarray(pj[name][k])
            if name.startswith("conv") and k == "w":
                ref = ref.transpose(3, 2, 0, 1)
            _close(v, ref, f"param {name}.{k} after two steps")


def test_grads_at_exact_zero_pre_activations_match_jax(model):
    """All-zero images and the zero-initialised biases make every
    pre-activation exactly 0, where ``jnp.maximum``'s gradient is 1/2:
    conv1's bias gradient is then 1/2 of its upstream sum in JAX, and was
    0 while the port's relu was ``torch.relu``."""
    pj, tree, images, labels = model
    images = images[:8].copy()
    images[:4] = 0.0
    (_, _), ref_grads = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        pj, jnp.asarray(images), jnp.asarray(labels[:8], jnp.int32))
    pt = _torch_params(tree, grad=True)
    loss, _ = M.loss_fn(pt, torch.from_numpy(images),
                        torch.from_numpy(labels[:8]))
    loss.backward()
    assert float(pt["conv1"]["b"].grad.abs().max()) > 0.0
    for name, layer in pt.items():
        for k, v in layer.items():
            ref = np.asarray(ref_grads[name][k])
            if name.startswith("conv") and k == "w":
                ref = ref.transpose(3, 2, 0, 1)
            _close(v.grad, ref, f"grad {name}.{k}")
