"""PyTorch port, the package root's import surface and ``compat``:
``configure_logging`` and the library's NullHandler, the lazy names of
the JAX package's ``__init__`` (each resolving to the port's own module),
an import of the root that loads neither JAX nor torch nor a submodule,
and the ``compat`` shims.  Two parity checks read both packages' sources
(no import): every JAX module has a counterpart with its public names,
and every ``TFOS_*`` variable the JAX package reads the port reads too,
but for the differences listed here, each with its reason."""

import ast
import importlib
import logging
import os
import re
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


# -- parity with the JAX package, read from the sources ----------------------

JAX_PKG = os.path.join(REPO, "tensorflowonspark_tpu")
PORT_PKG = os.path.join(REPO, "tensorflowonspark_tpu_torch")
MODULE_RENAMES = {"tpu_info.py": "gpu_info.py"}
# public names of a JAX module that its counterpart lacks: why
NAME_DIFFERENCES = {
    "compat.py": {"is_tpu_available": "compat.is_gpu_available"},
    "manager.py": {
        "JoinableItemQueue": "a plain queue.Queue (its own docstring: "
                             "the same semantics over proxies)",
        "beat": "start_heartbeat's thread writes the heartbeat key"},
    "pipeline.py": {"HasNumChips": "pipeline.HasNumGpus"},
    "tpu_info.py": {
        "MAX_RETRIES": "the TPU scan's retries; nvidia-smi is asked once",
        "claim_chips": "gpu_info.claim_gpus",
        "count_chips": "gpu_info.count_gpus",
        "get_chips": "gpu_info.get_gpus",
        "is_tpu_available": "compat.is_gpu_available",
        "set_visible_chips": "gpu_info.claim_gpus"},
    "actors/__init__.py": {
        "BudgetExhausted": "actors.supervise.BudgetExhausted"},
    "parallel/ring.py": {
        "shard_map": "JAX's shard_map import shim; the port's ring "
                     "functions take a process group"},
    "models/__init__.py": {"layers": "the module models.layers"},
    "models/mnist.py": {
        "serve_predict": "mnist.predict takes and returns numpy",
        "synthetic_batch": "a JAX-key data helper; the port's tests and "
                           "examples draw from numpy"},
    "serving/__init__.py": {
        "ElasticReplicaPool": "serving.elastic.ElasticReplicaPool"},
    "utils/__init__.py": {"child_pids_dir": "utils.hostinfo.child_pids_dir",
                          "find_in_path": "unused by the port"},
    "utils/hostinfo.py": {"find_in_path": "unused by the port"},
}
# TFOS_* variables (or key prefixes) the JAX package reads and the port
# does not: why
TFOS_DIFFERENCES = {
    "TFOS_NATIVE_LIB": "the JAX package's prebuilt native/ library; the "
                       "port builds its own (recordio._build)",
    "TFOS_TPU_CHIPS_PER_HOST": "gpu_info.COUNT_ENV, TFOS_GPUS_PER_HOST",
}


def _public_names(path):
    """Top-level public names a module defines (functions, classes,
    assignments), and, for a package's ``__init__``, re-exports."""
    tree = ast.parse(open(path).read())
    init = path.endswith("__init__.py")
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif init and isinstance(node, ast.ImportFrom):
            out |= {(a.asname or a.name) for a in node.names}
    return {n for n in out if not n.startswith("_")}


def _py_files(root):
    for base, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(base, f), root)


def test_every_jax_module_has_a_counterpart_with_its_public_names():
    """Each JAX module has a port module at its path (tpu_info.py:
    gpu_info.py), which defines every public name of it but those in
    NAME_DIFFERENCES, and each listed name is really missing."""
    missing = {}
    for rel in _py_files(JAX_PKG):
        head, tail = os.path.split(rel)
        port = os.path.join(PORT_PKG, head, MODULE_RENAMES.get(tail, tail))
        assert os.path.exists(port), f"no counterpart of {rel}"
        gone = _public_names(os.path.join(JAX_PKG, rel)) - \
            _public_names(port)
        if gone:
            missing[rel.replace(os.sep, "/")] = gone
    assert missing == {k: set(v) for k, v in NAME_DIFFERENCES.items()}


def _tfos_names(root):
    """The ``TFOS_*`` names a package's code holds as string constants
    (an ``os.environ`` key, or a module constant that names one), and the
    leading parts of f-strings (a prefix a family of names is built on);
    never a name only mentioned in a docstring or a message."""
    out = set()
    for rel in _py_files(root):
        with open(os.path.join(root, rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.JoinedStr) and node.values:
                node = node.values[0]
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    re.fullmatch(r"TFOS_[A-Z0-9_]+", node.value):
                out.add(node.value)
    return out


def test_the_port_reads_every_tfos_variable_of_the_jax_package():
    """Every ``TFOS_*`` name the JAX package's code holds as a string
    constant the port's holds too, but those in TFOS_DIFFERENCES."""
    assert _tfos_names(JAX_PKG) - _tfos_names(PORT_PKG) == \
        set(TFOS_DIFFERENCES)
