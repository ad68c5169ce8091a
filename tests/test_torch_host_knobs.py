"""PyTorch port, the node and host switches it shares with the JAX
package, on the CPU: ``TFOS_NODE_PORT``, ``TFOS_REAP_TIMEOUT``,
``TFOS_CHILD_PIDS_DIR``, ``TFOS_NATIVE_MARSHAL``, the host address
(``get_ip_address`` without ``TFOS_HOST_IP``) and ``single_node_env``'s
Hadoop classpath, each held against the JAX package's function where
it has one, else against its rule.
"""

import os
import socket
import stat
import tempfile

import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu.recordio import marshal as jmarshal  # noqa: E402
from tensorflowonspark_tpu.utils import hostinfo as jhostinfo  # noqa: E402
from tensorflowonspark_tpu_torch import node, parallel_run  # noqa: E402
from tensorflowonspark_tpu_torch.recordio import marshal  # noqa: E402
from tensorflowonspark_tpu_torch.utils import hostinfo  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def test_node_port_env_pins_the_reserved_port(monkeypatch):
    """TFOS_NODE_PORT is the port a node reserves for the coordinator;
    without it the node takes a free one."""
    port = _free_port()
    monkeypatch.setenv("TFOS_NODE_PORT", str(port))
    with node._reserve_port() as sock:
        assert sock.getsockname()[1] == port
    monkeypatch.delenv("TFOS_NODE_PORT")
    with node._reserve_port() as sock:
        assert sock.getsockname()[1] > 0


@pytest.mark.parametrize("env,grace,err,want", [
    (None, 0, None, 600.0), ("7", 0, None, 7.0), ("7", 30, None, 30.0),
    ("7", 30, "boom", 5.0)])
def test_reap_timeout_env_sets_the_healthy_budget(monkeypatch, env, grace,
                                                  err, want):
    """Shutdown's wait for the trainer: max(grace_secs,
    TFOS_REAP_TIMEOUT or 600), as the JAX package's; 5 s for a trainer
    that failed."""
    if env is None:
        monkeypatch.delenv("TFOS_REAP_TIMEOUT", raising=False)
    else:
        monkeypatch.setenv("TFOS_REAP_TIMEOUT", env)
    assert node._reap_budget(err, grace) == want


def test_child_pids_dir_env_as_the_jax_package(monkeypatch, tmp_path):
    """TFOS_CHILD_PIDS_DIR overrides the ledger's directory; without it
    an executor keeps its working dir and any other process a temp dir
    of its own, in both packages."""
    monkeypatch.setenv("TFOS_CHILD_PIDS_DIR", str(tmp_path))
    monkeypatch.setenv("TFOS_EXECUTOR_INDEX", "0")
    assert hostinfo.child_pids_dir() == jhostinfo.child_pids_dir() == \
        str(tmp_path)
    monkeypatch.delenv("TFOS_CHILD_PIDS_DIR")
    assert hostinfo.child_pids_dir() == jhostinfo.child_pids_dir() == \
        os.getcwd()
    monkeypatch.delenv("TFOS_EXECUTOR_INDEX")
    assert hostinfo.child_pids_dir() == jhostinfo.child_pids_dir() == \
        os.path.join(tempfile.gettempdir(), f"tfos-pids-{os.getpid()}")


def test_native_marshal_env_forces_the_numpy_marshal(monkeypatch):
    """TFOS_NATIVE_MARSHAL=0: neither package loads its extension, and
    the port builds nothing and takes the numpy path."""
    def no_build(names=None):
        raise AssertionError("built the marshal under TFOS_NATIVE_MARSHAL=0")

    monkeypatch.setenv("TFOS_NATIVE_MARSHAL", "0")
    monkeypatch.setattr(marshal._build, "build", no_build)
    for mod in (marshal, jmarshal):
        monkeypatch.setattr(mod, "_ext", None)
        monkeypatch.setattr(mod, "_ext_tried", False)
    assert not marshal.native_available()
    assert not jmarshal.native_available()
    assert marshal.path_for([("i", 0), ("d", 2)]) == "numpy"


def test_host_address_as_the_jax_package(monkeypatch):
    """Without TFOS_HOST_IP: the route's source address, the JAX
    package's; with it: its value."""
    monkeypatch.delenv(hostinfo.HOST_IP_ENV, raising=False)
    assert hostinfo.get_ip_address() == jhostinfo.get_ip_address()
    monkeypatch.setenv(hostinfo.HOST_IP_ENV, "10.1.2.3")
    assert hostinfo.get_ip_address() == "10.1.2.3"


def test_single_node_env_hadoop_classpath_as_the_jax_package(monkeypatch,
                                                             tmp_path):
    """A ``hadoop`` script under HADOOP_PREFIX: both packages append its
    ``classpath --glob`` to CLASSPATH once and set
    TFOS_CLASSPATH_UPDATED; with 0 devices nothing is claimed."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    hadoop = bin_dir / "hadoop"
    hadoop.write_text("#!/bin/sh\n[ \"$1 $2\" = \"classpath --glob\" ] && "
                      "echo hadoop-a.jar:hadoop-b.jar\n")
    hadoop.chmod(hadoop.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("HADOOP_PREFIX", str(tmp_path))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    got = {}
    for name, fn in (("port", hostinfo.single_node_env),
                     ("jax", jhostinfo.single_node_env)):
        monkeypatch.setenv("CLASSPATH", "/base.jar")
        monkeypatch.delenv("TFOS_CLASSPATH_UPDATED", raising=False)
        fn(0)
        first = os.environ["CLASSPATH"]
        fn(0)  # once a process
        got[name] = (first, os.environ["CLASSPATH"],
                     os.environ["TFOS_CLASSPATH_UPDATED"],
                     os.environ.get("CUDA_VISIBLE_DEVICES"))
    assert got["port"] == got["jax"] == (
        "/base.jar" + os.pathsep + "hadoop-a.jar:hadoop-b.jar\n",
        "/base.jar" + os.pathsep + "hadoop-a.jar:hadoop-b.jar\n",
        "1", None)


def test_parallel_task_sets_up_through_single_node_env(monkeypatch):
    """A parallel_run worker claims its GPUs through single_node_env with
    its same-host index, as the JAX package's worker does."""
    calls = []
    monkeypatch.setattr(parallel_run, "single_node_env",
                        lambda n, i: calls.append((n, i)))
    monkeypatch.delenv("TFOS_EXECUTOR_INDEX", raising=False)
    task = parallel_run._ParallelTask(
        lambda args, ctx: (args, ctx.task_index), "args",
        {"num_gpus": 2, "default_fs": "file://", "working_dir": "/tmp"}, 1)
    assert task(iter([0])) == [("args", 0)]
    assert calls == [(2, 0)]
