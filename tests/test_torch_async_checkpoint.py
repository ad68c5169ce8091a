"""PyTorch port, ``utils/checkpoint.AsyncCheckpointer``, on the CPU: the
JAX class's contract over npz files written on a background thread.

- ``save`` returns before the file is written, and the file holds the
  tree of its own step although the optimizer steps the parameters in
  place right after;
- a second ``save`` waits for the one in flight;
- pruning keeps ``keep``; ``restore_latest``/``restore_at`` give the
  trees back, and the JAX package's ``restore_latest``/``restore_any``
  read the port's files;
- an exception in the writer (an injected ``checkpoint.save`` fault)
  surfaces at the next ``save``/``wait``/``close``;
- ``close`` waits and is idempotent.

The writer is held on an event where a test needs the save in flight,
so nothing here depends on timing.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu.utils import checkpoint as JC  # noqa: E402
from tensorflowonspark_tpu_torch.utils import checkpoint as C  # noqa: E402
from tensorflowonspark_tpu_torch.utils import faults  # noqa: E402

TIMEOUT = 30


@pytest.fixture
def held(monkeypatch):
    """The writer thread waits for ``release`` before it writes."""
    release = threading.Event()
    save_flat = C._save_flat

    def gated(*args):
        assert release.wait(TIMEOUT)
        return save_flat(*args)

    monkeypatch.setattr(C, "_save_flat", gated)
    yield release
    release.set()


def _model(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"dense": {"w": torch.randn(6, 4, generator=g),
                        "b": torch.zeros(4)},
              "out": {"w": torch.randn(4, 3, generator=g)}}
    leaves = [p.requires_grad_() for layer in params.values()
              for p in layer.values()]
    return params, torch.optim.SGD(leaves, lr=0.5, momentum=0.9)


def _step(params, opt, seed):
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(seed))
    loss = (torch.tanh(x @ params["dense"]["w"] + params["dense"]["b"])
            @ params["out"]["w"]).pow(2).mean()
    opt.zero_grad()
    loss.backward()
    opt.step()


def _host(params):
    return {k: {n: v.detach().numpy().copy() for n, v in layer.items()}
            for k, layer in params.items()}


def _same(a, b):
    fa, fb = C._flatten(a), C._flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_save_returns_first_and_snapshots_its_step(held, tmp_path):
    params, opt = _model()
    ckpt = C.AsyncCheckpointer(str(tmp_path))
    _step(params, opt, 1)
    at_save = _host(params)
    ckpt.save(1, params)
    # the writer has not run: no file yet; the optimizer steps in place
    assert os.listdir(tmp_path) == []
    for s in (2, 3):
        _step(params, opt, s)
    assert not np.array_equal(params["out"]["w"].detach().numpy(),
                              at_save["out"]["w"])
    held.set()
    ckpt.wait()
    _same(C.load_checkpoint(str(tmp_path / "ckpt-00000001.npz")), at_save)
    ckpt.close()


def test_a_second_save_waits_for_the_first(held, tmp_path):
    params, _ = _model()
    ckpt = C.AsyncCheckpointer(str(tmp_path))
    ckpt.save(1, params)
    second = threading.Thread(target=ckpt.save, args=(2, params))
    second.start()
    second.join(0.2)
    assert second.is_alive()  # blocked behind step 1's writer
    held.set()
    second.join(TIMEOUT)
    assert not second.is_alive()
    ckpt.close()
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000001.npz",
                                            "ckpt-00000002.npz"]


def test_keep_restores_and_the_jax_package_reads_it(tmp_path):
    params, opt = _model()
    ckpt = C.async_checkpointer("file://" + str(tmp_path), keep=2)
    assert ckpt.restore_latest() == (None, 0)
    assert ckpt.latest_step() is None
    trees = {}
    for s in range(1, 5):
        _step(params, opt, s)
        trees[s] = _host(params)
        ckpt.save(s, params)
    ckpt.close()
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000003.npz",
                                            "ckpt-00000004.npz"]
    tree, step = ckpt.restore_latest()
    assert step == 4 == ckpt.latest_step()
    _same(tree, trees[4])
    _same(ckpt.restore_at(3), trees[3])
    for restore in (JC.restore_latest, JC.restore_any, C.restore_any):
        tree, step = restore(str(tmp_path))
        assert step == 4
        _same(tree, trees[4])


def test_writer_exception_surfaces_at_the_next_call(monkeypatch, tmp_path):
    monkeypatch.setenv(faults.PLAN_ENV, "checkpoint.save:exc@2")
    monkeypatch.delenv(faults.EXECUTOR_ENV, raising=False)
    params, _ = _model()
    ckpt = C.AsyncCheckpointer(str(tmp_path))
    ckpt.save(1, params)
    ckpt.save(2, params)   # its writer raises in the background
    with pytest.raises(faults.FaultInjected, match="checkpoint.save"):
        ckpt.save(3, params)
    ckpt.save(3, params)   # the error was raised once, and step 3 saves
    ckpt.save(4, params)
    ckpt.wait()
    assert C.latest_step(str(tmp_path)) == 4
    assert "ckpt-00000002.npz" not in os.listdir(tmp_path)
    ckpt.save(5, params)
    ckpt.wait()
    monkeypatch.setenv(faults.PLAN_ENV, "checkpoint.save:exc@*")
    ckpt.save(6, params)
    with pytest.raises(faults.FaultInjected):
        ckpt.close()
    ckpt.close()  # idempotent: nothing left to raise or wait for
    with pytest.raises(RuntimeError, match="after close"):
        ckpt.save(7, params)
