"""ImageNet record decode for the ResNet example: one definition of what a
valid record is.

Counterpart of ``examples/resnet/imagenet_records.py``.  Two layouts are
understood: this repo's writers (``"image"`` bytes and ``"label"``,
0-based) and the TF-official ImageNet keys (``"image/encoded"`` and
``"image/class/label"``, 1-based).  A payload of exactly
``image_size * image_size * 3`` bytes is raw uint8 HWC.  JPEG and PNG
payloads raise NotImplementedError: their decode (and
``imagenet_data_setup.py``, which converts JPEG shards to raw ones)
waits in ROADMAP.md queue 1, item 24.
"""

from __future__ import annotations

import numpy as np

JPEG_ITEM = "ROADMAP.md queue 1, item 24 (JPEG and PNG decode)"

_JPEG_MAGIC = b"\xff\xd8"
_PNG_MAGIC = b"\x89PNG"


def _payload_label(feats):
    """{name: value} or {name: [value]} -> (image payload, 0-based
    label); KeyError where the image or label field is missing."""
    data = feats.get("image", feats.get("image/encoded"))
    if data is None:
        raise KeyError(
            f"record has neither 'image' nor 'image/encoded' features "
            f"(got {sorted(feats)})")
    if isinstance(data, list):
        data = data[0]
    if "label" in feats:
        label = feats["label"]
    elif "image/class/label" in feats:
        label = feats["image/class/label"]
        label = (label[0] if isinstance(label, list) else label) - 1
    else:
        raise KeyError(
            f"record has neither 'label' nor 'image/class/label' "
            f"(got {sorted(feats)})")
    if isinstance(label, list):
        label = label[0]
    return data, label


def decode_record(feats, image_size):
    """One record as ``(uint8 [H, W, 3] array, 0-based int)``.

    ``feats``: {name: value} or {name: [value]} (the ``dfutil``-loaded
    and the raw ``decode_example`` shapes).  KeyError for a missing
    field; NotImplementedError for a JPEG or PNG payload (magic bytes win
    over the size rule, so a compressed image of H*W*3 bytes never reads
    as raw pixels); ValueError for any other payload that is not
    ``image_size`` x ``image_size`` x 3 bytes.  The array is a read-only
    view of the payload."""
    data, label = _payload_label(feats)
    return _decode_payload(data, label, image_size)


def _decode_payload(data, label, image_size):
    head = bytes(data[:4])
    if head[:2] == _JPEG_MAGIC or head == _PNG_MAGIC:
        raise NotImplementedError(
            f"{'JPEG' if head[:2] == _JPEG_MAGIC else 'PNG'} payloads come "
            f"with {JPEG_ITEM}; write raw uint8 records")
    raw = np.frombuffer(data, dtype=np.uint8)
    if raw.size == image_size * image_size * 3:
        return raw.reshape(image_size, image_size, 3), int(label)
    raise ValueError(
        f"image payload is {raw.size} bytes: neither "
        f"{image_size}x{image_size}x3 raw uint8 nor JPEG/PNG; check "
        f"--image_size against the dataset")


def decode_records_batch(recs, image_size):
    """Records -> [(uint8 [S, S, 3], int label)], each as
    :func:`decode_record` gives it.  Every record's fields are read
    before any payload is decoded, as in the JAX package."""
    items = [_payload_label(f) for f in recs]
    return [_decode_payload(data, label, image_size)
            for data, label in items]
