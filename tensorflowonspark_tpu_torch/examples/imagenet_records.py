"""ImageNet record decode for the ResNet example and
``imagenet_data_setup``: one definition of what a valid record is, so
the raw dataset the setup writes and the records the training example
accepts never drift apart.

Counterpart of ``examples/resnet/imagenet_records.py``.  Two layouts are
understood: this repo's writers (``"image"`` bytes and ``"label"``,
0-based) and the TF-official ImageNet keys (``"image/encoded"`` and
``"image/class/label"``, 1-based).  A JPEG payload decodes through
``recordio.jpeg`` (the native libjpeg decoder, PIL arbitrating what it
refuses), a PNG one through PIL, both resized bilinearly to
``image_size``; a payload of exactly ``image_size * image_size * 3``
bytes is raw uint8 HWC.
"""

from __future__ import annotations

import io

import numpy as np

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
    field; ValueError for a corrupt JPEG and for any other payload that
    is not JPEG, PNG or ``image_size`` x ``image_size`` x 3 bytes, so
    callers choose to skip or fail (PIL's own error for a corrupt PNG,
    as in the JAX package).  Magic bytes win over the size rule:
    a compressed image of H*W*3 bytes is decoded, never read as raw
    pixels.  A raw record's array is a read-only view of the payload."""
    data, label = _payload_label(feats)
    return _decode_payload(data, label, image_size)


def _decode_payload(data, label, image_size):
    head = bytes(data[:4])
    if head[:2] == _JPEG_MAGIC:
        from tensorflowonspark_tpu_torch.recordio import jpeg

        return jpeg.decode_resized(data, image_size), int(label)
    if head == _PNG_MAGIC:
        from PIL import Image

        img = Image.open(io.BytesIO(data)).convert("RGB")
        if img.size != (image_size, image_size):
            img = img.resize((image_size, image_size), Image.BILINEAR)
        return np.asarray(img, np.uint8), int(label)
    raw = np.frombuffer(data, dtype=np.uint8)
    if raw.size == image_size * image_size * 3:
        return raw.reshape(image_size, image_size, 3), int(label)
    raise ValueError(
        f"image payload is {raw.size} bytes: neither "
        f"{image_size}x{image_size}x3 raw uint8 nor JPEG/PNG; check "
        f"--image_size against the dataset")


def decode_records_batch(recs, image_size, threads=None):
    """Records -> [(uint8 [S, S, 3], int label)], each as
    :func:`decode_record` gives it, with every JPEG payload decoded
    through one threaded ``jpeg.decode_batch`` (``threads``: its pool's
    size; the C call releases the GIL, so the batch scales with cores).
    Raw and PNG records take the per-record path.  Every record's fields
    are read, and every non-JPEG payload decoded, before any JPEG, as in
    the JAX package: with several bad records the one whose error is
    raised may not be the first."""
    items = [_payload_label(f) for f in recs]
    out = [None] * len(items)
    jpeg_idx, jpeg_data = [], []
    for i, (data, label) in enumerate(items):
        if isinstance(data, (bytes, bytearray, memoryview)) \
                and bytes(data[:2]) == _JPEG_MAGIC:
            jpeg_idx.append(i)
            jpeg_data.append(bytes(data))
        else:
            out[i] = _decode_payload(data, label, image_size)
    if jpeg_idx:
        from tensorflowonspark_tpu_torch.recordio import jpeg

        imgs = jpeg.decode_batch(jpeg_data, image_size, threads=threads)
        for k, i in enumerate(jpeg_idx):
            out[i] = (imgs[k], int(items[i][1]))
    return out
