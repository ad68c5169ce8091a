"""The frozen FLOP and byte counts against hand-worked numbers."""

import json
from pathlib import Path

import pytest

from portbench import flops, frozen

PB = Path(__file__).resolve().parents[1]
PYTHIA = json.loads((PB / "configs" / "pythia-2.8b.json").read_text())
RESNET = json.loads((PB / "configs" / "resnet-50.json").read_text())


def test_pythia_matmul_weights():
    # per layer: qkv 2560x7680, out 2560x2560, MLP 2 x 2560x10240;
    # head 2560x50304; the embedding gather is no product
    layer = 2560 * 7680 + 2560 * 2560 + 2 * 2560 * 10240
    assert layer == 78_643_200
    assert flops.lm_matmul_params(PYTHIA) == 32 * layer + 128_778_240
    assert flops.lm_matmul_params(PYTHIA) == 2_645_360_640


def test_pythia_train_step():
    pairs = 2048 * 2049 // 2
    assert frozen.visible_pairs(2048, 2048, True) == pairs == 2_098_176
    fwd = 2 * 2048 * 2_645_360_640 + 4 * 2560 * 32 * pairs
    assert flops.lm_forward_flops(PYTHIA, 2048) == fwd
    step = flops.lm_train_step_flops(PYTHIA, 2, 2048)
    assert step == 3 * 2 * fwd
    assert step == pytest.approx(69.13756e12, rel=1e-6)
    # one decoded token attending to 1,000 positions
    assert flops.lm_decode_flops(PYTHIA, 1000) == \
        2 * 2_645_360_640 + 4 * 2560 * 32 * 1000


def test_resnet50_macs():
    # the stem alone: 112 x 112 outputs of a 7x7x3 window, 64 channels
    stem = 112 * 112 * 7 * 7 * 3 * 64
    assert stem == 118_013_952
    macs = flops.resnet_forward_macs(50, 224, 1000, 64)
    assert macs == 4_089_184_256        # torchvision lists 4.09 GMACs
    assert flops.resnet_forward_macs(50, 224, 10, 64) == macs - 2048 * 990
    step = flops.resnet_train_step_flops(RESNET, 256)
    assert step == 3 * 2 * 256 * macs


def test_flash_bounds_from_visible_pairs():
    # Pythia's attention, bf16: b 2, s 2048, 32 heads of 80
    ms, by = frozen.flash_bound_ms(2, 2048, 2048, 32, 80, True, "bfloat16")
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 4 * 2 * 32 * 80 * 2_098_176 / 989e12)
    dq, _ = frozen.flash_bwd_bound_ms("flash_dq", 2, 2048, 2048, 32, 80,
                                      True, "bfloat16")
    dkv, _ = frozen.flash_bwd_bound_ms("flash_dkv", 2, 2048, 2048, 32, 80,
                                       True, "bfloat16")
    assert dq == pytest.approx(1.5 * ms) and dkv == pytest.approx(2 * ms)
    # a memory-bound case: one query row over a long key range
    ms, by = frozen.flash_bound_ms(1, 1, 4096, 1, 128, False, "bfloat16")
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (2 * 128 * (2 + 2 * 4096) + 4)
                               / 3.35e12)


def test_union_and_breakdown():
    assert frozen._union([(0, 2), (1, 3), (5, 6)]) == 4
    b = frozen.device_breakdown([("a", 0, 1000), ("b", 500, 2000)], 0.004)
    assert b["device_busy_ms"] == 2.0 and b["idle_share"] == 0.5
