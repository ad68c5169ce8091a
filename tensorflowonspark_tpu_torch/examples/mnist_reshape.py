"""A flat MNIST CSV row as a 28x28 ASCII picture.

Counterpart of ``examples/utils/mnist_reshape.py``, a debugging aid for
inference output: a row of 784 pixels (or 785, the label first) in 0-255
becomes 28 lines of characters, darkest to brightest ``" .:-=+*#%@"``::

    python -m tensorflowonspark_tpu_torch.examples.mnist_reshape "0,0,...,255"
"""

from __future__ import annotations

import sys

import numpy as np

SCALE = " .:-=+*#%@"


def reshape(csv_row):
    """The picture of one CSV row, as one string of 28 lines."""
    vals = np.fromstring(csv_row, dtype=np.float32, sep=",")
    pixels = vals[1:] if len(vals) == 785 else vals
    img = pixels.reshape(28, 28)
    return "\n".join(
        "".join(SCALE[min(int(v / 256.0 * len(SCALE)), len(SCALE) - 1)]
                for v in row)
        for row in img)


if __name__ == "__main__":
    print(reshape(sys.argv[1]))
