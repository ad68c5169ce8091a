"""PyTorch port, ``utils.flops.count_flops`` (the function run on meta
tensors under ``FlopCounterMode``) against the JAX package's jaxpr
counter: the same totals, exactly, for the primitive cases of
``tests/test_flops.py`` (matmul, batched matmul, conv, depthwise conv,
transposed conv), for the segmentation model at (256, 21, 1.0) and
(64, 3, 0.5), and for MNIST a row; ResNet-50 against the published MAC
table, as the JAX package's counter is held.
"""

import jax
import jax.numpy as jnp
import pytest
from jax import lax

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu.utils import flops as JF  # noqa: E402
from tensorflowonspark_tpu.utils import metrics as JM  # noqa: E402
from tensorflowonspark_tpu_torch.models import layers as L  # noqa: E402
from tensorflowonspark_tpu_torch.models import resnet  # noqa: E402
from tensorflowonspark_tpu_torch.models import segmentation as S  # noqa: E402
from tensorflowonspark_tpu_torch.utils import metrics as M  # noqa: E402
from tensorflowonspark_tpu_torch.utils.flops import count_flops  # noqa: E402

_DN = ("NHWC", "HWIO", "NHWC")


def _jax_conv(stride, groups=1):
    return lambda x, w: lax.conv_general_dilated(
        x, w, (stride, stride), "SAME", feature_group_count=groups,
        dimension_numbers=_DN)


# name -> (port fn, port args, JAX fn, JAX args, MACs by hand)
CASES = {
    "matmul": (torch.matmul, (torch.ones(2, 3), torch.ones(3, 4)),
               jnp.dot, (jnp.ones((2, 3)), jnp.ones((3, 4))), 2 * 3 * 4),
    "batched_matmul": (
        lambda a, b: torch.einsum("bij,bjk->bik", a, b),
        (torch.ones(5, 2, 3), torch.ones(5, 3, 4)),
        lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
        (jnp.ones((5, 2, 3)), jnp.ones((5, 3, 4))), 5 * 2 * 3 * 4),
    # out (1, 4, 4, 16) x 9 taps x 3 in_ch
    "conv": (lambda x, w: L.conv({"w": w}, x, stride=2),
             (torch.ones(1, 3, 8, 8), torch.ones(16, 3, 3, 3)),
             _jax_conv(2), (jnp.ones((1, 8, 8, 3)), jnp.ones((3, 3, 3, 16))),
             1 * 4 * 4 * 16 * 9 * 3),
    # 9 taps an output element, one input channel each
    "depthwise": (lambda x, w: S._dwconv({"w": w}, x),
                  (torch.ones(1, 8, 4, 4), torch.ones(8, 1, 3, 3)),
                  _jax_conv(1, groups=8),
                  (jnp.ones((1, 4, 4, 8)), jnp.ones((3, 3, 1, 8))),
                  1 * 4 * 4 * 8 * 9),
    # output (1, 8, 8, 4); the zero-inserted positions are no work: / 4
    "conv_transpose": (
        lambda x, w: S._upconv({"w": w}, x),
        (torch.ones(1, 8, 4, 4), torch.ones(8, 4, 3, 3)),
        lambda x, w: lax.conv_transpose(x, w, (2, 2), "SAME",
                                        dimension_numbers=_DN),
        (jnp.ones((1, 4, 4, 8)), jnp.ones((3, 3, 8, 4))),
        (1 * 8 * 8 * 4) * 9 * 8 // 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_primitive_counts_equal_the_jax_counter(name):
    fn, args, jfn, jargs, macs = CASES[name]
    got = count_flops(fn, *args)
    want = JF.count_flops(jfn, *jargs)
    assert got["macs"] == want["macs"] == macs
    assert got["flops"] == want["flops"] == 2 * macs
    assert sum(got["by_op"].values()) == got["flops"]


def test_runs_on_meta_tensors_only():
    """Nothing is computed: the arguments reach the function on the meta
    device, and a full-size count allocates nothing."""
    seen = []

    def fn(x):
        seen.append(x.device.type)
        return x @ x

    r = count_flops(fn, torch.ones(4096, 4096))
    assert seen == ["meta"] and r["macs"] == 4096 ** 3


@pytest.mark.parametrize("size,classes,width,want", [
    (256, 21, 1.0, 494_206_976),
    (64, 3, 0.5, 5_998_592),
])
def test_segmentation_flops_equal_the_jax_counter(size, classes, width,
                                                  want):
    got = M.segmentation_flops_per_image(size, classes, width)
    assert got == JM.segmentation_flops_per_image(size, classes, width) \
        == want


def test_mnist_flops_per_row_equal_the_jax_counter():
    assert M.mnist_inference_flops_per_row() == \
        JM.mnist_inference_flops_per_row() == 8_482_304


def test_resnet50_count_matches_the_published_table():
    params, state = resnet.init(torch.Generator().manual_seed(0), depth=50)
    img = torch.empty((1, 224, 224, 3))
    counted = count_flops(
        lambda p, s, x: resnet.apply(p, s, x, compute_dtype=torch.float32,
                                     stem_s2d=False)[0],
        params, state, img)["flops"]
    table = resnet.flops_per_image(50, 224)
    assert counted == pytest.approx(table, rel=0.02), (counted, table)
