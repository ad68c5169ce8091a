"""PyTorch port, the serving examples on the CPU at the JAX examples'
small configs: ``examples/lm_decode.py`` (a 2-replica decode service:
one session token-identical to the full-recompute greedy decode,
seeded sampling reproducible, prefix hits, an open loop of 16 sessions
and one ``POST /v1/generate``) and ``examples/mnist_serving.py`` (32
concurrent clients, a hot reload, one ``POST /v1/predict``), each with
``--device cpu``; and the ``tfos-serve-torch`` console script's parser.
The examples' own asserts are the token gates; every wait in them is
bounded (300 s)."""

import pytest

pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch.examples import (  # noqa: E402
    lm_decode,
    mnist_serving,
)
from tensorflowonspark_tpu_torch.serving import server as S  # noqa: E402


def test_lm_decode_example_on_the_cpu():
    stats = lm_decode.main(["--device", "cpu", "--http"])
    assert stats["completed"] == stats["requests"] == 16
    assert stats["shed"] == stats["errors"] == 0
    assert stats["tokens"] == 16 * 16


def test_mnist_serving_example_on_the_cpu():
    summary, errors = mnist_serving.main(["--device", "cpu", "--http"])
    assert not errors
    assert summary["completed"] == 32 * 4 + 2 and summary["errors"] == 0
    assert summary["versions"] == {0: 2, 1: 2}
    assert summary["replicas"] == [0, 1]


def test_serve_cli_parser():
    args = S.build_parser().parse_args(
        ["--export_dir", "/e", "--port", "9000", "--device", "cpu"])
    assert args.export_dir == "/e" and args.port == 9000
    assert args.device == "cpu" and args.num_replicas is None
    assert S.build_parser().prog == "tfos-serve-torch"
