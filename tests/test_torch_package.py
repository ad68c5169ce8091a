"""PyTorch port, the package root's import surface and ``compat``:
``configure_logging`` and the library's NullHandler, the lazy names of
the JAX package's ``__init__`` (each resolving to the port's own module),
an import of the root that loads neither JAX nor torch nor a submodule,
and the ``compat`` shims."""

import importlib
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import tensorflowonspark_tpu_torch as pkg  # noqa: E402
from tensorflowonspark_tpu_torch import compat  # noqa: E402
from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX package's lazy names -> the port's (module, attribute)
LAZY = {
    "InputMode": ("cluster", "InputMode"),
    "TFCluster": ("cluster", None),
    "TFNode": ("feed", None),
    "TFNodeContext": ("node", "TFNodeContext"),
    "TFParallel": ("parallel_run", None),
    "compat": ("compat", None),
    "dfutil": ("dfutil", None),
    "infeed": ("infeed", None),
    "pipeline": ("pipeline", None),
    "serving": ("serving", None),
}


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    return out


def test_lazy_names_are_the_jax_packages():
    import tensorflowonspark_tpu as jax_pkg

    assert set(LAZY) == set(jax_pkg._LAZY)


@pytest.mark.parametrize("name", sorted(LAZY))
def test_lazy_name_resolves_to_the_ports_module(name):
    module, attr = LAZY[name]
    mod = importlib.import_module(f"tensorflowonspark_tpu_torch.{module}")
    got = getattr(pkg, name)
    assert got is (getattr(mod, attr) if attr else mod)
    owner = got if attr is None else sys.modules[got.__module__]
    assert owner.__name__.startswith("tensorflowonspark_tpu_torch.")


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no attribute 'TFNope'"):
        pkg.TFNope  # noqa: B018


def test_import_root_loads_no_jax_torch_or_submodule():
    """The root imports nothing but logging: no JAX, no torch, no
    submodule of its own, and ``TFCluster`` then brings in no JAX."""
    _run(r"""
import sys
import tensorflowonspark_tpu_torch as pkg
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "torch",
                                       "tensorflowonspark_tpu",
                                       "tensorflowonspark_tpu_torch"))
assert loaded == ["tensorflowonspark_tpu_torch"], loaded
pkg.TFCluster.run, pkg.InputMode.SPARK
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tensorflowonspark_tpu"))
assert not bad, bad
""")


def test_configure_logging_sets_the_reference_format():
    out = _run(r"""
import logging
import tensorflowonspark_tpu_torch as pkg
lib = logging.getLogger("tensorflowonspark_tpu_torch")
assert any(isinstance(h, logging.NullHandler) for h in lib.handlers)
assert not logging.getLogger().handlers
pkg.configure_logging()
logging.getLogger("tensorflowonspark_tpu_torch.x").info("hello port")
logging.getLogger("y").debug("not shown")
""")
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 1, out.stderr
    assert lines[0].endswith("hello port") and " INFO (MainThread-" in \
        lines[0], lines[0]


def test_configure_logging_takes_a_level():
    root = logging.getLogger()
    saved = root.level, root.handlers[:]
    root.handlers[:] = []
    try:
        pkg.configure_logging(logging.WARNING)
        assert root.level == logging.WARNING
    finally:
        root.handlers[:] = saved[1]
        root.setLevel(saved[0])


class _Ctx:
    def __init__(self, job_name, task_index):
        self.job_name, self.task_index = job_name, task_index
        self.cluster_spec = {"chief": ["h:0"], "worker": ["h:1"]}


def test_export_saved_model_on_the_chief_only(tmp_path):
    from tensorflowonspark_tpu.utils import checkpoint as jckpt

    params = {"fc": {"w": torch.arange(6.0).reshape(2, 3),
                     "b": torch.zeros(3)}}

    class Model:
        pass

    model = Model()
    model.params = params
    chief = str(tmp_path / "chief")
    assert compat.export_saved_model(model, chief, _Ctx("chief", 0),
                                     metadata={"k": 1}) == chief
    got, meta = jckpt.load_exported(chief)
    np.testing.assert_array_equal(got["fc"]["w"], params["fc"]["w"].numpy())
    assert meta["k"] == 1
    assert ckpt.load_exported(chief)[1]["format"] == ckpt.EXPORT_FORMAT
    worker = str(tmp_path / "worker")
    assert compat.export_saved_model(params, worker,
                                     _Ctx("worker", 0)) is None
    assert not os.path.exists(worker)


def test_disable_auto_shard_and_is_gpu_available():
    opts = object()
    assert compat.disable_auto_shard(opts) is opts
    assert compat.is_gpu_available() is torch.cuda.is_available()
