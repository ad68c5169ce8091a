"""PyTorch port, ``models/segmentation.py`` and its examples against the
JAX package on the CPU: the same params (the JAX model's, converted by
``segmentation.params_from_jax``) and the same seeded numpy images and
masks through both, at batch 2, 64x64, width 0.5, 3 classes.

Tolerances (worst measured in brackets):
- ``apply``, train and eval mode: logits within ``LOGIT_RTOL`` 1e-5 of
  the largest |logit| (3.1e-6, 4.6e-7);
- ``loss_fn``: the loss within ``LOSS_RTOL`` 1e-5 relative (1.9e-7);
- gradients: each leaf within ``GRAD_RTOL`` 1e-4 of the larger of its
  own largest element and ``ZERO_SCALE`` 1e-3 of the tree's largest
  gradient.  That floor exists for leaves whose exact value is ~0: a
  training-mode BN downstream removes their effect (the bias of a BN
  whose output reaches another BN through a 1x1 conv; the scale and bias
  of a BN ahead of a depthwise conv and its BN, up to ReLU6's clipping
  and the zero border).  Against the port in float64 such a leaf is
  3.6e-8 or less, where the tree's largest gradient is 4.6e-2, and both
  packages' float32 sums miss it by up to 1.4e-9 (4% of itself), the
  other leaves by 1.9e-5 of their largest element (JAX) and 2.1e-6
  (the port);
- the new BN state: each leaf within ``STATE_RTOL`` 1e-5 of the state
  tree's largest element (the running variances, ~1), for the same
  reason: a running mean of a BN fed by a BN through a 1x1 conv is ~0
  (1.8e-8 in float64), and float32 gives it up to 4.7e-8 of noise;
- five Adam(1e-3) steps of ``make_train_step`` against
  ``optax.adam(1e-3)``: the losses within ``ADAM_RTOL`` 1e-4 relative.

A layout, flip, padding or concat fault moves values by O(1) of their
size.  ``_upconv`` is held against ``lax.conv_transpose`` at even and
odd sizes, ``_dwconv`` at strides 1 and 2; ``batchnorm_relu6``'s
gradient at pre-activations of exactly 0 and 6 equals JAX's (0 at both).
The SPARK-fed example runs on two CPU executors (gloo) and its losses
equal an in-process run within ``SPARK_LOSS_RTOL`` (chip_smoke.py's);
its chief's checkpoint restores in the JAX package to the logits of the
in-process params.
"""

import argparse
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tensorflowonspark_tpu.models import segmentation as JS  # noqa: E402
from tensorflowonspark_tpu.utils import checkpoint as jckpt  # noqa: E402
from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    segmentation as seg_example,
)
from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    segmentation_spark,
)
from tensorflowonspark_tpu_torch.models import layers as L  # noqa: E402
from tensorflowonspark_tpu_torch.models import segmentation as S  # noqa: E402
from tensorflowonspark_tpu_torch.utils import train as TU  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOGIT_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_SCALE = 1e-3
STATE_RTOL = 1e-5
ADAM_RTOL = 1e-4
SPARK_LOSS_RTOL = 1e-3  # chip_smoke.SPARK_LOSS_RTOL
TIMEOUT = 120


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _items(tree, prefix=""):
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _items(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _close(got, ref, what, rtol, scale=None):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    scale = np.abs(ref).max() if scale is None else scale
    assert err <= rtol * max(scale, 1e-30), (what, err, scale)


def _close_trees(got, ref, what, rtol, floor=0.0):
    """Every leaf within ``rtol`` of the larger of its largest element and
    ``floor``."""
    g, r = _items(got), _items(ref)
    assert [p for p, _ in g] == [p for p, _ in r], what
    for (path, a), (_, b) in zip(g, r):
        _close(a, b, f"{what} {path}", rtol,
               max(float(np.abs(np.asarray(b)).max()), floor))


def _tree_max(tree):
    return max(float(np.abs(np.asarray(v)).max()) for _, v in _items(tree))


@pytest.fixture(scope="module")
def net():
    """(JAX params, JAX state, images, masks), made once."""
    pj, sj = jax.jit(lambda k: JS.init(k, num_classes=3, width=0.5))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    images = rng.random((2, 64, 64, 3), dtype=np.float32)
    masks = rng.integers(0, 3, (2, 64, 64)).astype(np.int32)
    return pj, sj, images, masks


def _torch_net(pj, sj):
    pt, st = S.params_from_jax(pj, sj, device="cpu")
    for p in S.param_leaves(pt):
        p.requires_grad_()
    return pt, st


# -- the layers the model adds ------------------------------------------------

@pytest.mark.parametrize("h", [8, 7])
def test_upconv_matches_lax_conv_transpose(h):
    """``conv_transpose2d`` of the flipped kernel, cropped to 2H: the JAX
    up-conv at even and odd H (``lax.conv_transpose`` pads the
    zero-inserted input by (2, 1), not ``nn.ConvTranspose2d``'s)."""
    rng = np.random.default_rng(h)
    x = rng.standard_normal((2, h, h + 1, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)
    ref = np.asarray(JS._upconv({"w": jnp.asarray(w)}, jnp.asarray(x)))
    pt, _ = S.params_from_jax({"up0": {"w": w}}, device="cpu")
    assert pt["up0"]["w"].shape == (5, 4, 3, 3)
    got = S._upconv(pt["up0"], torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 4, 2 * h, 2 * (h + 1))
    _close(got.permute(0, 2, 3, 1), ref, "upconv", LOGIT_RTOL)


@pytest.mark.parametrize("h", [8, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_dwconv_matches_jax(stride, h):
    """``F.conv2d(groups=C)`` with XLA's SAME pads (asymmetric at stride
    2) against ``feature_group_count=C``."""
    rng = np.random.default_rng(10 * stride + h)
    x = rng.standard_normal((2, h, h, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1, 6)).astype(np.float32)
    ref = np.asarray(JS._dwconv({"w": jnp.asarray(w)}, jnp.asarray(x),
                                stride=stride))
    pt, _ = S.params_from_jax({"dw": {"w": w}}, device="cpu")
    assert pt["dw"]["w"].shape == (6, 1, 3, 3)
    got = S._dwconv(pt["dw"], torch.from_numpy(x).permute(0, 3, 1, 2),
                    stride=stride)
    _close(got.permute(0, 2, 3, 1), ref, f"dwconv s{stride}", LOGIT_RTOL)


@pytest.mark.parametrize("fused", [True, False])
def test_batchnorm_relu6_boundary_gradient_matches_jax(fused):
    """Pre-activations of exactly 0 (scale and bias 0) and exactly 6
    (scale 0, bias 6) on two channels: ``jax.nn.relu6``'s gradient is 0
    at both boundaries, so those channels' bias gradients are 0, fused
    (``layers._relu6_gate``) and unfused."""
    from tensorflowonspark_tpu.models import layers as JL

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    scale = np.array([1.0, 0.0, 0.0, 0.5], np.float32)
    bias = np.array([0.3, 0.0, 6.0, 5.8], np.float32)
    state = {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p):
        y, _ = JL.batchnorm_relu6(p, state, jnp.asarray(x), fused=fused)
        return jnp.sum(y * g)

    ref = jax.grad(jloss)({"scale": jnp.asarray(scale),
                           "bias": jnp.asarray(bias)})
    pt = {"scale": torch.from_numpy(scale).requires_grad_(),
          "bias": torch.from_numpy(bias).requires_grad_()}
    st = {k: torch.from_numpy(v) for k, v in state.items()}
    y, _ = L.batchnorm_relu6(pt, st, torch.from_numpy(x).permute(0, 3, 1, 2),
                             fused=fused)
    pre = y.detach()
    assert float(pre[:, 1].abs().max()) == 0.0
    assert float(pre[:, 2].min()) == float(pre[:, 2].max()) == 6.0
    (y * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    for k in ("scale", "bias"):
        np.testing.assert_allclose(_np(pt[k].grad), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(pt["bias"].grad[1]) == float(pt["bias"].grad[2]) == 0.0
    assert float(np.asarray(ref["bias"])[2]) == 0.0


# -- the model ----------------------------------------------------------------

def test_trees_match_jax_and_round_trip(net):
    """Same names and nesting as the JAX trees (55 param and 36 state
    leaves); params_to_jax inverts params_from_jax exactly."""
    pj, sj, _, _ = net
    pt, st = S.params_from_jax(pj, sj, device="cpu")
    assert len(S.param_leaves(pt)) == 55 and len(_items(st)) == 36
    gen = torch.Generator().manual_seed(0)
    p0, s0 = S.init(gen, num_classes=3, width=0.5)
    assert [p for p, _ in _items(p0)] == [p for p, _ in _items(pt)]
    for (path, a), (_, b) in zip(_items(p0) + _items(s0),
                                 _items(pt) + _items(st)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    back_p, back_s = S.params_to_jax(pt, st)
    for (path, a), (_, b) in zip(_items(back_p) + _items(back_s),
                                 _items(pj) + _items(sj)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=path)


def test_entry_points_default_to_the_card(net):
    pj, sj, _, _ = net
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.params_from_jax(pj, sj)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seg_example.train(argparse.Namespace(
            batch_size=2, steps=1, image_size=32, width=0.5, lr=1e-3,
            device=None))


@pytest.mark.parametrize("train", [True, False])
def test_apply_matches_jax(net, train):
    pj, sj, images, _ = net
    ref, ref_state = JS.apply(pj, sj, jnp.asarray(images), train=train)
    pt, st = S.params_from_jax(pj, sj, device="cpu")
    with torch.no_grad():
        logits, new_state = S.apply(pt, st, torch.from_numpy(images),
                                    train=train)
    assert logits.shape == (2, 64, 64, 3)
    _close(logits, ref, "logits", LOGIT_RTOL)
    _close_trees(S.params_to_jax(pt, new_state)[1], ref_state, "state",
                 STATE_RTOL, _tree_max(ref_state))


def test_loss_grads_and_state_match_jax(net):
    pj, sj, images, masks = net
    (ref_loss, ref_state), ref_grads = jax.jit(jax.value_and_grad(
        JS.loss_fn, has_aux=True))(pj, sj, jnp.asarray(images),
                                   jnp.asarray(masks))
    pt, st = S.params_from_jax(pj, sj, device="cpu")
    (loss, new_state), grads = TU.value_and_grad(S.loss_fn, has_aux=True)(
        pt, st, torch.from_numpy(images), torch.from_numpy(masks))
    _close(loss, ref_loss, "loss", LOSS_RTOL)
    _close_trees(S.params_to_jax(grads)[0], ref_grads, "grads", GRAD_RTOL,
                 ZERO_SCALE * _tree_max(ref_grads))
    _close_trees(S.params_to_jax(pt, new_state)[1], ref_state, "state",
                 STATE_RTOL, _tree_max(ref_state))


def test_adam_steps_match_optax(net):
    """Five steps of ``make_train_step`` with ``torch.optim.Adam(1e-3)``
    against the JAX step with ``optax.adam(1e-3)`` on one batch."""
    pj, sj, images, masks = net
    opt = optax.adam(1e-3)
    step = jax.jit(JS.make_train_step(opt))
    p, s, o = pj, sj, opt.init(pj)
    ref = []
    for _ in range(5):
        p, s, o, loss = step(p, s, o, jnp.asarray(images),
                             jnp.asarray(masks))
        ref.append(float(loss))
    pt, st = _torch_net(pj, sj)
    step_t = S.make_train_step(torch.optim.Adam(S.param_leaves(pt),
                                                lr=1e-3))
    got = []
    for _ in range(5):
        loss, st = step_t(pt, st, torch.from_numpy(images),
                          torch.from_numpy(masks))
        got.append(float(loss))
    np.testing.assert_allclose(got, ref, rtol=ADAM_RTOL)
    assert got[-1] < got[0]


# -- the examples -------------------------------------------------------------

def test_synthetic_pets_equal_the_jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_segmentation_example",
        os.path.join(REPO, "examples", "segmentation", "segmentation.py"))
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    for n, hw, seed in ((6, 64, 0), (3, 32, 5)):
        want = jex.synthetic_pets(n, hw=hw, seed=seed)
        got = seg_example.synthetic_pets(n, hw=hw, seed=seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_single_process_example_trains_on_the_cpu(capsys):
    params, state = seg_example.train(argparse.Namespace(
        batch_size=2, steps=5, image_size=32, width=0.5, lr=1e-3,
        device="cpu"))
    out = capsys.readouterr().out
    assert "step 5: loss=" in out
    assert np.isfinite(float(out.split("loss=")[-1]))
    assert params["head"]["w"].shape[1] == 3
    assert all(torch.isfinite(t).all() for _, t in _items(state))


SPARK = dict(batch=8, steps=3, hw=32, width=0.5)


@pytest.fixture(scope="module")
def spark_run(tmp_path_factory):
    """``segmentation_spark.main_fun`` on two CPU executors (gloo), from
    the JAX model's params, over two partitions of synthetic pets (one
    per executor: with 4-record chunks a feeder stays busy until its
    trainer pops the last chunk); returns (rank reports, records, JAX
    params, model_dir)."""
    tmp = tmp_path_factory.mktemp("seg_spark")
    pj, _ = jax.jit(lambda k: JS.init(k, num_classes=3,
                                      width=SPARK["width"]))(
        jax.random.PRNGKey(1))
    pj = jax.tree_util.tree_map(np.asarray, pj)
    images, masks = seg_example.synthetic_pets(
        SPARK["batch"] * SPARK["steps"], hw=SPARK["hw"], seed=2)
    records = list(zip(list(images), list(masks)))
    engine = LocalEngine(2, env={"OMP_NUM_THREADS": "2",
                                 "TFOS_FEED_CHUNK": "4"})
    try:
        c = TFCluster.run(
            engine, segmentation_spark.main_fun,
            {"batch_size": SPARK["batch"], "lr": 1e-3,
             "width": SPARK["width"],
             "model_dir": str(tmp / "model"), "device": "cpu",
             "init_params": pj, "out_dir": str(tmp)},
            num_executors=2, input_mode=TFCluster.InputMode.SPARK,
            master_node="chief", reservation_timeout=TIMEOUT)
        c.train(engine.parallelize(records, 2), feed_timeout=TIMEOUT)
        assert c.server.fed_partitions("input") == [0, 1]
        c.shutdown()
    finally:
        engine.stop()
    reports = [json.load(open(tmp / f"segmentation-rank{r}.json"))
               for r in (0, 1)]
    return reports, records, pj, str(tmp / "model")


def _in_process(pj, records):
    """The two ranks' steps in one process: each step, each partition's
    next 4 records, normalised with the statistics of all 8 (the global
    batch, as the ranks' batch norm reduces them), one Adam step on the
    gradient of the mean of the two halves' losses (the ranks' averaged
    gradients).  Returns (per-step [loss of partition 0, of 1], params)."""
    half = SPARK["batch"] // 2
    parts = (records[:len(records) // 2], records[len(records) // 2:])
    _, st = S.init(torch.Generator().manual_seed(0), num_classes=3,
                   width=SPARK["width"])
    pt, _ = S.params_from_jax(pj, device="cpu")
    leaves = [p.requires_grad_() for p in S.param_leaves(pt)]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    vg = TU.value_and_grad(S.loss_fn, has_aux=True)
    losses = []
    for j in range(SPARK["steps"]):
        xs, ms = zip(*(segmentation_spark.collate(
            part[j * half:(j + 1) * half]) for part in parts))
        x = torch.from_numpy(np.concatenate(xs))
        m = torch.from_numpy(np.concatenate(ms))
        with torch.no_grad():
            logits, _ = S.apply(pt, st, x, train=True)
        losses.append([float(S.L.softmax_cross_entropy(
            lg.reshape(-1, lg.shape[-1]), mk.reshape(-1)))
            for lg, mk in ((logits[:half], m[:half]),
                           (logits[half:], m[half:]))])
        _, g = vg(pt, st, x, m)
        for p, a in zip(leaves, S.param_leaves(g)):
            p.grad = a
        opt.step()
    return losses, pt


def test_spark_fed_losses_equal_in_process(spark_run):
    reports, records, pj, _ = spark_run
    ref, _ = _in_process(pj, records)
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert len(r["losses"]) == SPARK["steps"], r["losses"]
        assert r["records"] == len(records) // 2
        assert r["feed"]["columnar"], r["feed"]
        assert not any(r["launches"].values()), r["launches"]
    for j in range(SPARK["steps"]):
        got = sorted(r["losses"][j] for r in reports)
        np.testing.assert_allclose(got, sorted(ref[j]), rtol=SPARK_LOSS_RTOL,
                                   err_msg=f"step {j}")


def test_spark_checkpoint_restores_in_jax(spark_run):
    """The chief's checkpoint (the JAX layout) loads in the JAX package
    and gives the logits of the in-process params."""
    reports, records, pj, model_dir = spark_run
    tree, step = jckpt.restore_latest(os.path.join(model_dir, "ckpt"))
    assert step == SPARK["steps"]
    _, pt = _in_process(pj, records)
    x, _ = segmentation_spark.collate(records[:4])
    _, sj = jax.jit(lambda k: JS.init(k, num_classes=3,
                                      width=SPARK["width"]))(
        jax.random.PRNGKey(0))
    got, _ = jax.jit(lambda p, s, x: JS.apply(p, s, x, train=True))(
        tree, sj, jnp.asarray(x))
    _, st = S.init(torch.Generator().manual_seed(0), num_classes=3,
                   width=SPARK["width"])
    with torch.no_grad():
        want, _ = S.apply(pt, st, torch.from_numpy(x), train=True)
    _close(np.asarray(got), _np(want), "restored logits", SPARK_LOSS_RTOL)
