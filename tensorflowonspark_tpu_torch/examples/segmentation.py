"""U-Net segmentation, single process: step 1 of the conversion ladder.

Counterpart of ``examples/segmentation/segmentation.py`` (single process
-> over a process group, ``segmentation_dist`` -> cluster-fed,
``segmentation_spark``).  The same flags and defaults; ``--device cpu``
runs on the CPU, the default is the card::

    python -m tensorflowonspark_tpu_torch.examples.segmentation --steps 10
"""

from __future__ import annotations

import argparse

import numpy as np


def synthetic_pets(n, hw=64, seed=0):
    """Images with a bright disc; mask = {0: background, 1: disc, 2: rim}.
    The JAX example's arrays, number for number."""
    rng = np.random.default_rng(seed)
    images = rng.random((n, hw, hw, 3), dtype=np.float32) * 0.3
    masks = np.zeros((n, hw, hw), dtype=np.int32)
    yy, xx = np.mgrid[:hw, :hw]
    for i in range(n):
        cy, cx = rng.integers(hw // 4, 3 * hw // 4, 2)
        r = int(rng.integers(hw // 8, hw // 4))
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        disc, rim = d2 <= (r - 2) ** 2, (d2 > (r - 2) ** 2) & (d2 <= r**2)
        images[i][disc] += 0.6
        images[i][rim] += 0.3
        masks[i][disc], masks[i][rim] = 1, 2
    return np.clip(images, 0, 1), masks


def train(args):
    """``args.steps`` Adam steps on batches drawn (numpy seed 0) from
    ``4 x args.batch_size`` synthetic pets; returns (params, state)."""
    import torch

    from tensorflowonspark_tpu_torch import resolve_device
    from tensorflowonspark_tpu_torch.models import segmentation

    dev = resolve_device(getattr(args, "device", None))
    images, masks = synthetic_pets(args.batch_size * 4, hw=args.image_size)
    params, state = segmentation.init(
        torch.Generator(device=dev).manual_seed(0), num_classes=3,
        width=args.width)
    leaves = [p.requires_grad_() for p in segmentation.param_leaves(params)]
    step_fn = segmentation.make_train_step(
        torch.optim.Adam(leaves, lr=args.lr))

    rng = np.random.default_rng(0)
    for step in range(1, args.steps + 1):
        idx = rng.integers(0, len(images), args.batch_size)
        loss, state = step_fn(params, state,
                              torch.from_numpy(images[idx]).to(dev),
                              torch.from_numpy(masks[idx]).to(dev))
        if step % 5 == 0:
            print(f"step {step}: loss={float(loss):.4f}")
    return params, state


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--width", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    train(p.parse_args())


if __name__ == "__main__":
    main()
