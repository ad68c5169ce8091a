"""PyTorch port, cluster roles on the CPU: ps, evaluator and chief nodes
run and stop (the JAX package's ``tests/test_roles_and_shims.py``), on
executors and with ``driver_ps_nodes``; ps and evaluator nodes claim no
GPU; TensorBoard on the dashboard node; the sidecar-evaluator example;
``TFCluster.inference()``; the deprecated TF1 shims.

The ``main_fun``s are module-level functions of this file, which the
executors import, so this file imports no JAX at the top.
"""

import json
import os
import stat
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import feed, gpu_info  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.utils import (  # noqa: E402
    get_ip_address,
    profiler,
)

TIMEOUT = 60  # seconds: registration, collectives, feed consumption


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:  # a zombie is gone
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def role_writer_fn(args, ctx):
    """Each node writes ``<job>-<task>``: its executor id, pid and the
    GPUs it sees."""
    path = os.path.join(args["dir"], f"{ctx.job_name}-{ctx.task_index}")
    with open(path, "w") as f:
        json.dump({"executor_id": ctx.executor_id, "pid": os.getpid(),
                   "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "env": ctx.torch_initialize("cpu").get("process_id")}, f)


def _fake_gpus_engine(n):
    return LocalEngine(n, env={"OMP_NUM_THREADS": "1",
                               gpu_info.COUNT_ENV: str(n),
                               "CUDA_VISIBLE_DEVICES": None,
                               gpu_info.INHERITED_ENV: None})


def test_ps_eval_chief_roles_run_and_stop(tmp_path):
    """``num_ps`` + ``eval_node`` + a chief, as the JAX package's test:
    ps and evaluator run the user's function in a forked process and
    hold their slots until shutdown's stop message; the chief and worker
    claim a GPU each, ps and evaluator none; every role's process is
    gone after shutdown."""
    engine = _fake_gpus_engine(4)
    try:
        cluster = TFCluster.run(
            engine, role_writer_fn, {"dir": str(tmp_path)},
            num_executors=4, num_ps=1, eval_node=True, master_node="chief",
            input_mode=TFCluster.InputMode.TENSORFLOW, num_gpus=1,
            reservation_timeout=TIMEOUT)
        jobs = sorted(m["job_name"] for m in cluster.cluster_info)
        assert jobs == ["chief", "evaluator", "ps", "worker"]
        assert cluster.meta["cluster_template"] == {
            "ps": [0], "evaluator": [1], "chief": [2], "worker": [3]}
        side = [m for m in cluster.cluster_info
                if m["job_name"] in ("ps", "evaluator")]
        cluster.shutdown(grace_secs=1)
        assert not cluster._launcher.is_alive()
    finally:
        engine.stop()
    wrote = {name: json.load(open(tmp_path / name))
             for name in sorted(os.listdir(tmp_path))}
    assert sorted(wrote) == ["chief-0", "evaluator-0", "ps-0", "worker-0"]
    assert wrote["ps-0"]["cuda_visible"] == ""
    assert wrote["evaluator-0"]["cuda_visible"] == ""
    assert wrote["chief-0"]["cuda_visible"] == "2"
    assert wrote["worker-0"]["cuda_visible"] == "3"
    # ranks: chief 0, worker 1; ps and evaluator are outside the group
    assert [wrote[k]["env"] for k in ("chief-0", "worker-0", "ps-0",
                                      "evaluator-0")] == [0, 1, None, None]
    assert not [w["pid"] for w in wrote.values() if _alive(w["pid"])]
    assert len(side) == 2 and all(m["addr"][0] for m in side)


def test_driver_ps_nodes_run_and_stop(tmp_path):
    """With ``driver_ps_nodes`` the ps nodes run on driver threads beside
    the executors' nodes, and stop through their remote managers."""
    engine = _fake_gpus_engine(2)
    try:
        cluster = TFCluster.run(
            engine, role_writer_fn, {"dir": str(tmp_path)},
            num_executors=2, num_ps=2, driver_ps_nodes=True,
            master_node="chief", input_mode=TFCluster.InputMode.TENSORFLOW,
            reservation_timeout=TIMEOUT)
        assert cluster.meta["cluster_template"] == {
            "ps": [2, 3], "chief": [0], "worker": [1]}
        cluster.shutdown()
        assert not any(t.is_alive() for t in cluster._driver_ps)
    finally:
        engine.stop()
    assert sorted(os.listdir(tmp_path)) == ["chief-0", "ps-0", "ps-1",
                                            "worker-0"]
    with pytest.raises(ValueError, match="TENSORFLOW"):
        TFCluster.run(engine, role_writer_fn, {}, 2, num_ps=1,
                      driver_ps_nodes=True,
                      input_mode=TFCluster.InputMode.SPARK)
    with pytest.raises(ValueError, match="num_ps"):
        TFCluster.run(engine, role_writer_fn, {}, 2, num_ps=2)


def failing_eval_fn(args, ctx):
    if ctx.job_name == "evaluator":
        raise ValueError("boom in evaluator")


def test_failing_evaluator_reaches_the_driver():
    """The evaluator's error surfaces through its control loop: the
    launcher's job fails, and shutdown exits the driver with 1, as the
    JAX package's does."""
    engine = _fake_gpus_engine(2)
    try:
        cluster = TFCluster.run(
            engine, failing_eval_fn, {}, num_executors=2, eval_node=True,
            input_mode=TFCluster.InputMode.TENSORFLOW,
            reservation_timeout=TIMEOUT)
        cluster._launcher.join(timeout=TIMEOUT)
        assert "boom in evaluator" in TFCluster.tf_status["error"]
        with pytest.raises(SystemExit):
            cluster.shutdown()
    finally:
        engine.stop()


# -- TensorBoard --------------------------------------------------------------

def _fake_tensorboard(bin_dir):
    """A ``tensorboard`` on PATH that just sleeps."""
    os.makedirs(bin_dir, exist_ok=True)
    path = os.path.join(bin_dir, "tensorboard")
    with open(path, "w") as f:
        f.write(f"#!{sys.executable}\nimport time\ntime.sleep(600)\n")
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def test_launch_tensorboard_finds_it_on_path(tmp_path, monkeypatch):
    fake = _fake_tensorboard(str(tmp_path / "bin"))
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    assert profiler._find_tensorboard() == [fake]
    proc, port = profiler.launch_tensorboard(str(tmp_path / "logs"))
    try:
        assert proc.poll() is None and port > 0
    finally:
        profiler.stop_tensorboard(proc)
    assert proc.poll() is not None
    monkeypatch.setattr(profiler, "_find_tensorboard", lambda: None)
    assert profiler.launch_tensorboard(str(tmp_path / "logs")) == (None,
                                                                   None)


def tb_main(args, ctx):
    return None


def test_dashboard_node_runs_tensorboard_until_shutdown(tmp_path):
    """``tensorboard=True``: the chief starts it, its port travels in the
    reservation (``tensorboard_url``), and shutdown stops it."""
    bin_dir = str(tmp_path / "bin")
    _fake_tensorboard(bin_dir)
    engine = LocalEngine(2, env={
        "OMP_NUM_THREADS": "1",
        "PATH": f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}"})
    try:
        cluster = TFCluster.run(
            engine, tb_main, {}, num_executors=2, master_node="chief",
            input_mode=TFCluster.InputMode.TENSORFLOW, tensorboard=True,
            log_dir=str(tmp_path / "tb"), reservation_timeout=TIMEOUT)
        url = cluster.tensorboard_url()
        # the chief's advertised address (hostinfo.get_ip_address)
        assert url and url.startswith(f"http://{get_ip_address()}:")
        (chief,) = [m for m in cluster.cluster_info
                    if m["job_name"] == "chief"]
        assert "tb_port" in chief
        pids = _child_pids(engine)
        cluster.shutdown()
    finally:
        engine.stop()
    assert not [p for p in pids if _alive(p)]


def _child_pids(engine):
    from tensorflowonspark_tpu_torch.utils import read_child_pids

    return [p for d in engine.executor_dirs for p in read_child_pids(d)]


# -- the sidecar-evaluator example --------------------------------------------

def test_mnist_eval_example_roles(tmp_path):
    """``examples/mnist_eval``: ps, evaluator, chief and worker on four
    executors (CPU, gloo); the evaluator writes one line a checkpoint
    step, the last one the final step, and every role stops."""
    from tensorflowonspark_tpu_torch.examples import mnist_eval

    model_dir = str(tmp_path / "model")
    mnist_eval.reset_model_dir(model_dir)
    args = {"num_examples": 256, "batch_size": 32, "steps": 20,
            "ckpt_steps": 10, "lr": 0.05, "eval_timeout": TIMEOUT,
            "model_dir": model_dir, "device": "cpu", "backend": None}
    engine = LocalEngine(4, env={"OMP_NUM_THREADS": "1"})
    try:
        cluster = TFCluster.run(
            engine, mnist_eval.main_fun, args, num_executors=4, num_ps=1,
            eval_node=True, master_node="chief",
            input_mode=TFCluster.InputMode.TENSORFLOW,
            reservation_timeout=TIMEOUT)
        cluster.shutdown(grace_secs=1)
    finally:
        engine.stop()
    evals = [json.loads(ln) for ln in
             open(os.path.join(model_dir, "eval_results.jsonl"))]
    steps = [e["step"] for e in evals]
    assert steps == sorted(set(steps)) and steps[-1] == 20, evals
    assert all(0.0 <= e["accuracy"] <= 1.0 for e in evals)
    records = {n: json.load(open(os.path.join(model_dir, f"{n}.json")))
               for n in ("ps-0", "evaluator-0", "chief-0", "worker-0")}
    assert records["evaluator-0"]["last_step"] == 20
    assert records["chief-0"]["device"] == "cpu"
    assert len(records["chief-0"]["losses"]) == 20
    assert all(np.isfinite(records["worker-0"]["losses"]))
    assert not [r["pid"] for r in records.values() if _alive(r["pid"])]


# -- TFCluster.inference() ----------------------------------------------------

def squares_fn(args, ctx):
    data = ctx.get_data_feed(train_mode=False)
    while not data.should_stop():
        batch = data.next_batch(100)
        if batch:
            data.batch_results([x * x for x in batch])


@pytest.mark.parametrize("shm", ["1", "0"])
def test_cluster_inference_returns_each_row_once(shm):
    """The reference's functional baseline (the squares of 0..999) over
    the ring and over the manager queue: every row's result once, in
    partition order."""
    engine = LocalEngine(2, env={"OMP_NUM_THREADS": "1",
                                 "TFOS_SHM_FEED": shm,
                                 "TFOS_FEED_CHUNK": "64"})
    try:
        cluster = TFCluster.run(engine, squares_fn, {}, num_executors=2,
                                input_mode=TFCluster.InputMode.SPARK,
                                reservation_timeout=TIMEOUT)
        out = cluster.inference(engine.parallelize(range(1000), 4),
                                feed_timeout=TIMEOUT).collect()
        cluster.shutdown()
    finally:
        engine.stop()
    assert out == [x * x for x in range(1000)]
    assert sum(out) == 332833500


def test_inference_requires_spark_mode():
    c = TFCluster.TFCluster()
    c.input_mode = TFCluster.InputMode.TENSORFLOW
    with pytest.raises(ValueError, match="SPARK"):
        c.inference([])


# -- the deprecated TF1 shims -------------------------------------------------

class _Ctx:
    job_name, task_index = "chief", 0
    cluster_spec = {"chief": [{}]}

    def torch_initialize(self, device=None):
        return {"coordinator_address": "127.0.0.1:1234",
                "num_processes": 1, "process_id": 0}


def test_deprecated_tfnode_shims_warn_as_the_jax_package(tmp_path):
    from tensorflowonspark_tpu.utils import checkpoint as jax_ckpt

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        server = feed.start_cluster_server(_Ctx())
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert server.target == "127.0.0.1:1234"
    with pytest.raises(RuntimeError):
        server.join()
    export_dir = str(tmp_path / "exp")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        feed.export_saved_model(export_dir=export_dir,
                                params={"w": np.zeros((2,), np.float32)},
                                ctx=_Ctx())
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
    params, _ = jax_ckpt.load_exported(export_dir)
    np.testing.assert_array_equal(np.asarray(params["w"]), np.zeros(2))
    with pytest.raises(ValueError):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            feed.export_saved_model(export_dir=export_dir)
