"""Tiny configurations, mixes and cells for the CPU tests: the cells'
own drivers and checks at sizes a test run holds."""

from __future__ import annotations

import json
from pathlib import Path

PB = Path(__file__).resolve().parents[1]


def _load(kind, name):
    return json.loads((PB / kind / f"{name}.json").read_text())


LM = dict(_load("configs", "pythia-2.8b"), hidden_size=64,
          num_attention_heads=2, intermediate_size=256, vocab_size=256,
          max_position_embeddings=64, num_hidden_layers=2)
LM_TRAIN = dict(_load("traffic", "train.spark"), sequence_length=64,
                batch=4, pool=32, partition_records=8, max_epochs=20,
                trace_seconds=1)
# float32: at 32x32 and 8 images bf16's rounding swamps the comparison
RESNET = dict(_load("configs", "resnet-50"), image_size=32, num_classes=10,
              dtype="float32")
RESNET_TRAIN = dict(_load("traffic", "train.tfrecord"), images=64, shards=4,
                    batch=8, max_epochs=50, trace_seconds=1,
                    optimizer={"name": "sgd", "lr": 0.001, "momentum": 0.9})
SERVE = dict(_load("traffic", "serve.chat"), rate=40.0, slots=4,
             requests=3000, prompt_median=16, prompt_min=8, prompt_max=40,
             output_median=6, output_min=4, output_max=12, warm_rows=2,
             warm_s=1, drain_s=30, trace_seconds=1, check_tokens=40)

# limits for the tiny sizes, between the program's readings there and
# the float8 control's.  At 32x32 and 8 images ResNet's later steps are
# chaotic: two float32 runs of the same function (the stem as a 7x7 or
# as space-to-depth) differ by 2% in BN gradients, and its step-3 loss
# by tens of percent, so its loss limit is loose here and the median
# leaf's gaps do the work
TRAIN_LIMITS = {"loss_gap": 2e-3, "grad_gap": 1e-2, "change_gap": 5e-2,
                "feed_mismatch": 0}
RESNET_LIMITS = {"loss_gap": 1.0, "grad_gap_weights": 1e-2,
                 "change_gap_weights": 5e-2, "feed_mismatch": 0}
SERVE_LIMITS = {"served_gap": 0.2, "unended": 0, "failed": 0}

CELLS = {
    "pythia-2.8b.train.spark": (LM, LM_TRAIN),
    "resnet-50.train.tfrecord": (RESNET, RESNET_TRAIN),
    "pythia-2.8b.serve.chat": (LM, SERVE),
}


def overrides(cell, main_fun=None, limits=None):
    """The cell's files at the tiny size (its config's ``main_fun``
    replaced by ``main_fun``, its limits by ``limits``)."""
    cfg, traffic = CELLS[cell]
    c = (_load("cells", cell) if (PB / "cells" / f"{cell}.json").is_file()
         else {"config": "pythia-2.8b", "traffic": "serve.chat", "chips": 1,
               "why": "the served cell's driver at a tiny size"})
    c["limits"] = limits or (SERVE_LIMITS if "serve" in cell else
                             RESNET_LIMITS if "resnet" in cell
                             else TRAIN_LIMITS)
    if main_fun:
        cfg = dict(cfg, train_main_fun=main_fun)
    return {"cell": c, "config": cfg, "traffic": traffic}
