"""Plain float32 reference of ResNet-50 as the port builds it (He et al.
2015, the ImageNet bottleneck plan): XLA's SAME padding, batch norm on
the batch's biased statistics (eps 1e-5), ReLU, a 3x3/2 SAME max pool,
the stride on each block's 3x3, a 1x1 projection where the shape
changes, global average pool, a dense head with bias, softmax cross
entropy.  Images enter as uint8 NHWC and are cast, unnormalised.

The initial weights are drawn again from the seed in the port's order
and scales (a copy of ``models/resnet.init`` and ``models/layers``'
``conv_init``/``dense_init``, files
``tensorflowonspark_tpu_torch/models/resnet.py:123`` and
``models/layers.py:49-103``): He-normal kernels over ``h * w * in``,
the dense weight over its input width, BN scale 1 and bias 0, the dense
bias 0.  Training recomputes each block in the backward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.flops import RESNET_PLANS
from portbench.reference import no_tf32, rounder


def _plan(cfg):
    """(name, in_ch, ch, stride) of every bottleneck block."""
    w, in_ch, out = cfg["width"], cfg["width"], []
    for stage, blocks in enumerate(RESNET_PLANS[cfg["depth"]]):
        ch = w * 2 ** stage
        for b in range(blocks):
            out.append((f"s{stage}b{b}", in_ch, ch,
                        2 if (b == 0 and stage > 0) else 1))
            in_ch = 4 * ch
    return out


def _specs(cfg):
    """``(path, shape, fan_in)`` of every leaf in the order the port
    draws them; ``fan_in`` None for BN scales (1) and biases (0)."""
    def conv(path, k, cin, cout):
        return [(f"{path}/w", (cout, cin, k, k), k * k * cin)]

    def bn(path, ch):
        return [(f"{path}/scale", (ch,), None), (f"{path}/bias", (ch,), None)]

    w = cfg["width"]
    out = conv("stem", 7, 3, w) + bn("bn_stem", w)
    for name, cin, ch, stride in _plan(cfg):
        out += conv(f"{name}/conv1", 1, cin, ch) + bn(f"{name}/bn1", ch)
        out += conv(f"{name}/conv2", 3, ch, ch) + bn(f"{name}/bn2", ch)
        out += conv(f"{name}/conv3", 1, ch, 4 * ch) + bn(f"{name}/bn3",
                                                         4 * ch)
        if stride != 1 or cin != 4 * ch:
            out += conv(f"{name}/proj", 1, cin, 4 * ch)
            out += bn(f"{name}/bn_proj", 4 * ch)
    in_ch = 4 * w * 2 ** (len(RESNET_PLANS[cfg["depth"]]) - 1)
    return out + [("fc/w", (in_ch, cfg["num_classes"]), in_ch),
                  ("fc/b", (cfg["num_classes"],), None)]


def init_leaves(cfg, seed, device):
    """``(path, float32 tensor)`` in the order the port draws them."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    for name, shape, fan_in in _specs(cfg):
        if fan_in is not None:
            yield name, torch.randn(shape, generator=g, device=device,
                                    dtype=torch.float32) \
                * math.sqrt(2.0 / fan_in)
        elif name.endswith("/scale"):
            yield name, torch.ones(shape, device=device)
        else:
            yield name, torch.zeros(shape, device=device)


def optimizer_order(cfg):
    """The port's optimizer takes the leaves with every level's keys
    sorted."""
    return sorted((n for n, _, _ in _specs(cfg)),
                  key=lambda n: tuple(n.split("/")))


def product_weights(cfg):
    """Which leaves, in :func:`optimizer_order`, are products' weights:
    the convolutions' kernels and the dense layer's."""
    return [n.endswith("/w") for n in optimizer_order(cfg)]


def _same(size, window, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, product):
    k = w.shape[-1]
    (t, b), (l, r) = (_same(x.shape[2], k, stride),
                      _same(x.shape[3], k, stride))
    return product(lambda x, w: F.conv2d(F.pad(x, (l, r, t, b)), w,
                                         stride=stride), x, w)


def _bn(x, p, path, eps=1e-5):
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0,
                               keepdim=True)
    scale = p[f"{path}/scale"].view(1, -1, 1, 1)
    bias = p[f"{path}/bias"].view(1, -1, 1, 1)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _block(x, p, name, stride, has_proj, product):
    short = x
    if has_proj:
        short = _bn(_conv(x, p[f"{name}/proj/w"], stride, product), p,
                    f"{name}/bn_proj")
    y = torch.relu(_bn(_conv(x, p[f"{name}/conv1/w"], 1, product), p,
                       f"{name}/bn1"))
    y = torch.relu(_bn(_conv(y, p[f"{name}/conv2/w"], stride, product),
                       p, f"{name}/bn2"))
    y = _bn(_conv(y, p[f"{name}/conv3/w"], 1, product), p, f"{name}/bn3")
    return torch.relu(y + short)


def logits(p, images, cfg, precision="float32", remat=False):
    """uint8 [N, H, W, 3] images -> float32 logits [N, classes]."""
    product = rounder(precision)
    x = images.permute(0, 3, 1, 2).float()
    x = torch.relu(_bn(_conv(x, p["stem/w"], 2, product), p, "bn_stem"))
    t, b = _same(x.shape[2], 3, 2)
    l, r = _same(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), 3, 2)
    for name, cin, ch, stride in _plan(cfg):
        has_proj = stride != 1 or cin != 4 * ch
        if remat:
            x = checkpoint(_block, x, p, name, stride, has_proj, product,
                           use_reentrant=False)
        else:
            x = _block(x, p, name, stride, has_proj, product)
    x = x.mean(dim=(2, 3))
    return product(torch.matmul, x, p["fc/w"]) + p["fc/b"]


def train_readings(cfg, seed, batches, device, precision, opt):
    """SGD with momentum over ``batches`` (each (uint8 images, int
    labels)) from the seeded weights: each step's loss, each leaf's
    first gradient norm, each leaf's change after the last step."""
    no_tf32()
    order = optimizer_order(cfg)
    params = {n: t.requires_grad_(True)
              for n, t in init_leaves(cfg, seed, device)}
    lr, mom = opt["lr"], opt["momentum"]
    buf = {}
    losses, grad_norms = [], None
    for images, labels in batches:
        images = torch.as_tensor(images, device=device)
        labels = torch.as_tensor(labels, dtype=torch.long, device=device)
        for p in params.values():
            p.grad = None
        out = F.cross_entropy(logits(params, images, cfg, precision,
                                     remat=True), labels)
        out.backward()
        losses.append(float(out.detach()))
        if grad_norms is None:
            grad_norms = [_norm(params[n].grad) for n in order]
        with torch.no_grad():
            for n in order:
                g = params[n].grad
                buf[n] = g.clone() if n not in buf else buf[n].mul_(mom).add_(g)
                params[n].add_(buf[n], alpha=-lr)
        del out
    change = {}
    with torch.no_grad():
        for n, p0 in init_leaves(cfg, seed, device):
            change[n] = _norm(params[n] - p0)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": [change[n] for n in order]}


def _norm(t):
    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))
