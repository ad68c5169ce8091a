"""PyTorch port, ops/: the port's attention and norm ops held against the
JAX package on the same numpy inputs (CPU).

The JAX flash attention runs its Pallas kernels in interpret mode, as
tests/test_ops.py does; the port's ``flash_attention`` on a CPU tensor
runs its plain versions, forward and backward.  The CUDA kernels
themselves are checked against those plain versions on the card by
chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu import ops as jops  # noqa: E402
from tensorflowonspark_tpu.ops import attention as jattn  # noqa: E402
from tensorflowonspark_tpu_torch import ops as tops  # noqa: E402
from tensorflowonspark_tpu_torch.ops import attention as tattn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def test_rope_angles_and_apply_match_jax():
    cos_j, sin_j = jops.rope_angles(128, 16)
    cos_t, sin_t = tops.rope_angles(128, 16)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)
    x = np.random.default_rng(3).standard_normal((2, 8, 2, 16)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(8) + 32, (2, 8)).astype(np.int32)
    for positions in (None, pos):
        ref = jops.apply_rope(jnp.asarray(x), cos_j, sin_j,
                              positions=None if positions is None
                              else jnp.asarray(positions))
        got = tops.apply_rope(_t(x), cos_t, sin_t,
                              positions=None if positions is None
                              else torch.from_numpy(positions).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_jax(causal):
    q, k, v = _qkv(0, 2, 24, 2, 16)
    ref = jops.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    got = tops.mha_reference(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_rmsnorm_reference_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 17, 64)).astype(np.float32)
    scale = (rng.standard_normal(64) + 1.0).astype(np.float32)
    ref = jops.rmsnorm_reference(jnp.asarray(x), jnp.asarray(scale))
    got = tops.rmsnorm_reference(_t(x), _t(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [64, 96])  # 96: tail-masking path
def test_flash_plain_matches_jax_pallas(seq, causal, dtype):
    """The port's CPU flash path against the JAX Pallas kernel (interpret
    mode) on the same inputs: out, and the lse the backward consumes."""
    q, k, v = _qkv(seq + causal, 2, seq, 2, 16)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                  for a in (jq, jk, jv))
    ref = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                               block_kv=64)
    got = tops.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                               block_kv=64)
    assert got.dtype == tdt and got.shape == tq.shape
    atol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=atol)
    scale = 1.0 / np.sqrt(16)
    _, lse_ref = jattn._flash_forward(jq, jk, jv, causal=causal, scale=scale,
                                      block_q=64, block_kv=64,
                                      interpret=True)
    _, lse = tattn._flash_forward(tq, tk, tv, causal=causal, scale=scale)
    assert lse.shape == (2, 2, seq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=1e-5)


def test_flash_plain_one_token_and_strided_views():
    """Sq == 1 (a one-token prompt bucket) and q/k/v as non-contiguous
    views of a fused qkv tensor, as the transformer passes them."""
    rng = np.random.default_rng(7)
    for s in (1, 5):
        qkv = rng.standard_normal((2, s, 3, 2, 16)).astype(np.float32)
        t = _t(qkv)
        got = tops.flash_attention(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                                   causal=True)
        ref = jops.mha_reference(*(jnp.asarray(qkv[:, :, i])
                                   for i in range(3)), causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_flash_plain_differentiable_on_cpu():
    q, k, v = (_t(a).requires_grad_() for a in _qkv(1, 1, 32, 2, 8))
    tops.flash_attention(q, k, v, causal=True).pow(2).sum().backward()
    q2, k2, v2 = (x.detach().clone().requires_grad_() for x in (q, k, v))
    tops.mha_reference(q2, k2, v2, causal=True).pow(2).sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=2e-4)


@pytest.mark.parametrize("head_dim,match,case", [
    # head_dim 32 is built now (it named the built (64, 128) before):
    # it reaches the device check
    pytest.param(32, "CUDA tensor", "f32", id=r"32-\(64, 128\)"),
    # above 256 is the chunked kernels' (257 padded to 384), no limit
    pytest.param(257, "CUDA tensor", "f32",
                 id="257-chunked-padded-reaches-the-device-check"),
    pytest.param(512, "q must start on a 16-byte", "bf16 q base",
                 id="512-chunked-bf16-misaligned-q-base"),
    pytest.param(72, "CUDA tensor", "f16",
                 id="72-padded-reaches-the-device-check"),
    pytest.param(64, "CUDA tensor", "f32", id="64-CUDA tensor"),
    pytest.param(128, "q must start on a 16-byte", "bf16 q base",
                 id="bf16-misaligned-q-base"),
    pytest.param(128, "q must start on a 16-byte", "f16 q base",
                 id="f16-misaligned-q-base"),
    pytest.param(128, "CUDA tensor", "bf16 fused qkv",
                 id="bf16-fused-qkv-views-pass-to-the-device-check"),
])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(head_dim, match,
                                                            case):
    """The kernel wrapper never falls back: every head_dim (a built one,
    a multiple of 128 above 256 that the chunked kernels run, or one the
    wrapper zero-pads to either) goes on to the other checks; a bf16 or
    f16 q that the
    tensor-core kernel cannot copy in 16-byte vectors (one element past a
    16-byte boundary) is refused before the device check, while views of
    a fused qkv projection pass that check; and a CPU tensor handed to it
    is refused last."""
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16}.get(
        case[:4].strip(), torch.float32)
    qkv = _t(np.random.default_rng(2).standard_normal(
        (1, 8, 3, 2, head_dim)).astype(np.float32), dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if case != "bf16 fused qkv":
        q, k, v = (x.contiguous() for x in (q, k, v))
    if case.endswith("q base"):
        q = _shifted(q)
    before = tattn.launches
    with pytest.raises(ValueError, match=match):
        tattn._flash_forward_cuda(q, k, v, causal=True, scale=0.125)
    assert tattn.launches == before == 0


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port (``spark_ml`` with the pyspark
    test double on the path), resolving the root's lazy names, running a
    pipeline of the data service's ``data`` package, running the actor
    workloads' members and the streaming examples' helpers, using the
    elastic pool's, the fabric's and the deploy loop's modules, importing
    chip_smoke.py, running both observability CLIs, and
    loading the port's host-native ring, marshal, TFRecord codec and
    JPEG decoder (and routing a TFRecord and a checkpoint through
    ``memory://``), leaves jax, cloudpickle and every
    tensorflowonspark_tpu module out of sys.modules,
    maps each of those libraries from ``build/torch_native/``, and maps
    no library built from ``native/`` or shipped in the JAX package."""
    code = r"""
import importlib, os, pkgutil, sys
# spark_ml needs pyspark: the test double, which imports nothing of JAX
sys.path.insert(0, os.path.join(os.getcwd(), "tests", "sparkstub"))
os.environ["TFOS_ALLOW_SPARK_STUB"] = "1"
import tensorflowonspark_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
for n in pkg._LAZY:   # the root's lazy names (TFCluster, compat, ...)
    getattr(pkg, n)
# the data service and the actor runtime, by name and used
from tensorflowonspark_tpu_torch import data
from tensorflowonspark_tpu_torch.actors import runtime
from tensorflowonspark_tpu_torch.data import service, splits
import numpy as np
blocks = list(data.from_arrays({"y": np.arange(6)}, 4).shuffle(4, 1)
              .batch(3).blocks())
assert sorted(int(v) for b in blocks for v in b["y"]) == list(range(6))
assert runtime.actor_table() == [] and splits.sid_to_part((1, 2))
assert service.dispatch_mode({"data_dispatch": "static"}) == "static"
# the actor workloads and the streaming examples, imported and run
import operator, tempfile
from tensorflowonspark_tpu_torch import rendezvous, workloads
from tensorflowonspark_tpu_torch.actors import ledger
from tensorflowonspark_tpu_torch.examples import (
    mnist_reshape, mnist_spark_streaming, stop_streaming)
from tensorflowonspark_tpu_torch.utils import checkpoint as ck
assert workloads.TrialActor(operator.add).on_message(
    None, "trial", {"trial": 0, "config": 2, "budget": 1})["score"] == 3.0
class _KV(dict):
    set = dict.__setitem__
    def kv(self):
        return self
class _Ctx:
    ledger = ledger.KVLedger(_KV(), "eval")
    events = []
    def kv_set(self, key, value):
        pass
    def emit(self, kind, payload):
        self.events.append((kind, payload))
ckdir = tempfile.mkdtemp()
ck.save_checkpoint(ckdir, {"w": np.ones(3)}, 2)
side, ctx = workloads.EvalSidecar(ckdir, lambda tree, step: {"n": 3}), _Ctx()
side.on_tick(ctx)
side.on_tick(ctx)
assert ctx.events == [("eval/result", {"step": 2, "metrics": {"n": 3}})]
assert side.on_message(ctx, "evaluated", None) == [2]
assert len(mnist_reshape.reshape(",".join(["9"] * 784)).splitlines()) == 28
assert len(mnist_spark_streaming.pad_tail(
    np.zeros((1, 28, 28, 1)), np.zeros(1), 4)[1]) == 4
server = rendezvous.Server(1)
host, port = server.start()
stop_streaming.main([host, str(port)])
assert server.done.wait(10)
server.stop()
import runpy
runpy.run_path("chip_smoke.py", run_name="not_main")
from tensorflowonspark_tpu_torch import recordio
from tensorflowonspark_tpu_torch.recordio import marshal, shm
assert shm.available() and marshal.native_available()
assert recordio.codec() == "native"
q = shm.ShmQueue(f"/tfosq-torch-iso-{os.getpid()}", 1 << 12, create=True)
q.put(marshal.rows_to_columns([(1.0, 2)], [("d", 0), ("l", 0)]))
q.close()
ex = recordio.encode_example({"x": ("int64", [3])})
assert recordio.decode_example(ex) == {"x": ("int64", [3])}
from tensorflowonspark_tpu_torch.recordio import jpeg
from tensorflowonspark_tpu_torch.utils import checkpoint
assert jpeg.available(), jpeg.error()
with recordio.TFRecordWriter("memory://iso/part-r-00000") as w:
    w.write(ex)
assert list(recordio.TFRecordReader("memory://iso/part-r-00000")) == [ex]
checkpoint.save_checkpoint("memory://iso/ckpt", {"w": [1.0]}, 1)
assert checkpoint.restore_latest("memory://iso/ckpt")[1] == 1
# the serving tier's elastic pool, fabric and deploy loop, used
import pickle
from tensorflowonspark_tpu_torch.obs import top
from tensorflowonspark_tpu_torch.serving import elastic, fabric, replicas
from tensorflowonspark_tpu_torch.serving.fabric import autoscale, host
from tensorflowonspark_tpu_torch.workloads import deploy_loop
assert elastic.assign_slots(6, [0, 1, 2]) == {0: 2, 1: 2, 2: 2}
assert elastic.pool_table() == [] and fabric.fabric_table() == []
assert isinstance(pickle.loads(elastic.params_blob(
    {"w": __import__("torch").ones(2)}))["w"], np.ndarray)
assert fabric.Ring([(0, 0), (1, 0)]).lookup("s1") in ((0, 0), (1, 0))
plans = []
assert autoscale.ServeAutoscaler(
    read_signal=lambda: {0: {"workers": 1, "depth": 9}},
    apply_plan=plans.append, max_replicas=2).step(now=0.0) == "up"
assert plans == [{0: 2}] and host.PLAN_KEY == "fabric:plan"
assert replicas.canary_arm("r", 100) and deploy_loop.deploy_table() == []
ck.save_checkpoint(ckdir, {"w": np.ones(3)}, 3)
ck.bless_checkpoint(ckdir, 3, score=0.5)
assert ck.latest_blessed(ckdir)[0] == 3
assert top.render_pods({}) and top.render_deploy({})
# both observability CLIs run: no endpoint, no flight dump
import io, tempfile
from tensorflowonspark_tpu_torch.obs import postmortem, top
assert top.main(["--url", "http://127.0.0.1:9", "--once"]) == 2
assert postmortem.main(["--dir", tempfile.mkdtemp()], out=io.StringIO()) == 2
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "cloudpickle"
             or m == "tensorflowonspark_tpu"
             or m.startswith("tensorflowonspark_tpu."))
repo = os.getcwd()
maps = {line.split()[-1] for line in open("/proc/self/maps")
        if line.rstrip().endswith(".so") or ".so." in line}
ours = sorted(m for m in maps if m.startswith(repo))
foreign = [m for m in ours
           if m.startswith((os.path.join(repo, "native") + os.sep,
                            os.path.join(repo, "tensorflowonspark_tpu")
                            + os.sep))]
print(len(names), bad, ours)
assert len(names) >= 15, names
for want in ("utils.train", "utils.metrics", "infeed", "models.transformer",
             "ops.attention", "recordio.shm", "recordio.marshal",
             "recordio.tfrecord_native", "dfutil", "examples.mnist_tf_ds",
             "serving.server", "serving.replicas", "serving.batcher",
             "actors.dispatch", "actors.liveness", "serving.decode.loadgen",
             "examples.lm_decode", "examples.mnist_serving", "pipeline",
             "inference", "parallel_run", "utils.schema", "utils.profiler",
             "models.linear", "spark_ml", "examples.mnist_pipeline",
             "examples.mnist_inference", "examples.mnist_eval",
             "models.segmentation", "utils.flops", "compat",
             "examples.segmentation", "examples.segmentation_spark",
             "recordio.jpeg", "recordio.fs", "utils.checkpoint",
             "examples.imagenet_data_setup", "examples.imagenet_records",
             "parallel", "parallel.mesh", "parallel.sharding",
             "parallel.ring", "parallel.pipeline_parallel",
             "parallel.collectives", "parallel.launch", "parallel.dryrun",
             "models.moe", "examples.transformer_longcontext",
             "examples.segmentation_dist", "serving.decode.scheduler",
             "elastic", "elastic.virtual", "elastic.reshard",
             "elastic.runtime", "obs", "obs.flight", "obs.health",
             "obs.publish", "obs.slo", "obs.http", "obs.top",
             "obs.postmortem", "data", "data.pipeline", "data.service",
             "data.splits", "data.cache", "data.autoscale",
             "actors.runtime", "actors.mailbox", "actors.policy",
             "workloads", "workloads.eval_sidecar", "workloads.sweep",
             "workloads.deploy_loop", "serving.elastic", "serving.fabric",
             "serving.fabric.affinity", "serving.fabric.autoscale",
             "serving.fabric.host", "serving.fabric.router",
             "examples.mnist_spark_streaming", "examples.stop_streaming",
             "examples.mnist_reshape"):
    assert "tensorflowonspark_tpu_torch." + want in names, (want, names)
assert not bad, bad
assert not foreign, foreign
built = os.path.join(repo, "build", "torch_native") + os.sep
for lib in ("libtfos_torch_shmq.so", "_tfos_torch_marshal.so",
            "libtfos_torch_tfrecord.so", "libtfos_torch_jpeg.so"):
    assert built + lib in ours, (lib, ours)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# -- the backward ------------------------------------------------------------

def _sq_loss_grads_jax(q, k, v, causal, block_q, block_kv, bwd_impl):
    def f(q, k, v):
        return jnp.sum(jops.flash_attention(
            q, k, v, causal=causal, block_q=block_q, block_kv=block_kv,
            bwd_impl=bwd_impl) ** 2)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))]


def _sq_loss_grads_torch(fn, q, k, v):
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    fn(*ts).pow(2).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("bwd_impl", ["xla", "pallas"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [64, 96])  # 96: tail-masking blocks
def test_flash_backward_matches_jax(seq, causal, bwd_impl):
    """Gradients of sum(out²) through the port's flash_attention (its
    autograd Function, plain backward on the CPU) against the JAX
    package's flash under both of its backwards (the Pallas one in
    interpret mode), mirroring tests/test_ops.py's pallas-backward
    cases, at their 5e-4."""
    q, k, v = _qkv(100 + seq + causal, 2, seq, 2, 16)
    ref = _sq_loss_grads_jax(q, k, v, causal, 64, 64, bwd_impl)
    got = _sq_loss_grads_torch(
        lambda q, k, v: tops.flash_attention(q, k, v, causal=causal,
                                             block_q=64, block_kv=64,
                                             bwd_impl=bwd_impl), q, k, v)
    for r, g, name in zip(ref, got, "qkv"):
        np.testing.assert_allclose(g, r, atol=5e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [64, 96])
def test_flash_backward_matches_mha_reference_autograd(seq, causal):
    """The port's flash gradients against autograd through the port's
    full-materialisation ``mha_reference``, at f32 gradient tolerance."""
    q, k, v = _qkv(200 + seq + causal, 2, seq, 2, 16)
    got = _sq_loss_grads_torch(
        lambda q, k, v: tops.flash_attention(q, k, v, causal=causal,
                                             block_q=32), q, k, v)
    ref = _sq_loss_grads_torch(
        lambda q, k, v: tops.mha_reference(q, k, v, causal=causal), q, k, v)
    for r, g, name in zip(ref, got, "qkv"):
        np.testing.assert_allclose(g, r, atol=2e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("block_q", [32, 48])  # 48: a partial last block
def test_flash_backward_plain_uneven_blocks(block_q):
    """``flash_backward_plain`` on the same (q, k, v, out, lse, g) as the
    JAX Pallas backward with block_q != block_kv (64/32), the case that
    exercises both kernels' diagonal bounds, mirroring
    tests/test_ops.py's uneven-blocks case at its 5e-4."""
    q, k, v = _qkv(5, 1, 128, 1, 8)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(8)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, causal=True, scale=scale,
                                    block_q=64, block_kv=32, interpret=True)
    ref = jattn._flash_backward_pallas(
        jq, jk, jv, out, lse, jg, causal=True, scale=scale, block_q=64,
        block_kv=32, interpret=True)
    got = tops.flash_backward_plain(
        _t(q), _t(k), _t(v), _t(np.array(out)), _t(np.array(lse)),
        _t(g), causal=True, scale=scale, block_q=block_q)
    for r, t, name in zip(ref, got, "qkv"):
        assert t.dtype == torch.float32 and t.shape == (1, 128, 1, 8)
        np.testing.assert_allclose(t.numpy(), np.asarray(r), atol=5e-4,
                                   err_msg=f"d{name}")


def test_flash_backward_plain_bf16_matches_jax_xla():
    """bf16 inputs: f32 math inside, gradients in bf16, against the JAX
    XLA backward on the same residuals (3e-2, the bf16 tolerance of
    tests/test_ops.py)."""
    q, k, v = _qkv(8, 2, 96, 2, 16)
    g = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    scale = 0.25
    jq, jk, jv, jg = (jnp.asarray(a).astype(jnp.bfloat16)
                      for a in (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, causal=True, scale=scale,
                                    block_q=64, block_kv=64, interpret=True)
    ref = jattn._flash_bwd_xla(True, scale, 64, 64,
                               (jq, jk, jv, out, lse), jg)

    def tt(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)

    got = tops.flash_backward_plain(
        tt(jq), tt(jk), tt(jv), tt(out), _t(np.array(lse)), tt(jg),
        causal=True, scale=scale, block_q=64)
    for r, t, name in zip(ref, got, "qkv"):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   atol=3e-2, err_msg=f"d{name}")


def test_flash_attention_validates_bwd_impl():
    q, k, v = (_t(a) for a in _qkv(3, 1, 8, 1, 8))
    with pytest.raises(ValueError, match="bwd_impl"):
        tops.flash_attention(q, k, v, bwd_impl="triton")
    with pytest.raises(ValueError, match="bwd_impl"):
        jops.flash_attention(*(jnp.asarray(a) for a in _qkv(3, 1, 8, 1, 8)),
                             bwd_impl="triton")


def test_cpu_backward_never_reaches_the_kernel_wrappers(monkeypatch):
    """On a machine without CUDA, forward and backward of flash_attention
    take the plain versions: the CUDA wrappers are never called and no
    launch is counted."""
    def boom(*a, **kw):
        raise AssertionError("CUDA wrapper reached from a CPU tensor")

    monkeypatch.setattr(tattn, "_flash_forward_cuda", boom)
    monkeypatch.setattr(tattn, "_flash_backward_cuda", boom)
    monkeypatch.setattr(tattn, "_lib", boom)
    before = (tattn.launches, tattn.dq_launches, tattn.dkv_launches)
    qkv = _t(np.random.default_rng(4).standard_normal(
        (2, 40, 3, 2, 64)).astype(np.float32)).requires_grad_()
    out = tops.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                               causal=True, bwd_impl="pallas")
    out.sum().backward()
    assert torch.isfinite(qkv.grad).all()
    assert (tattn.launches, tattn.dq_launches, tattn.dkv_launches) == before


def _shifted(x):
    """x's values in a view that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def _padded(x, dim):
    """x's values in a view whose stride on ``dim`` (seq 1, head 2) is 4
    elements longer, so it is no whole number of 16-byte vectors in
    bf16."""
    b, s, h, d = x.shape
    if dim == 1:
        y = torch.empty((b, s, h * d + 4), dtype=x.dtype)[..., :h * d]
        y = y.unflatten(-1, (h, d))
    else:
        y = torch.empty((b, s, h, d + 4), dtype=x.dtype)[..., :d]
    y.copy_(x)
    return y


@pytest.mark.parametrize("head_dim,match,case", [
    # head_dims 32 and 96 are built now (they named the built (64, 128)
    # before): they reach the device check
    pytest.param(32, "CUDA tensor", "f32", id=r"32-\(64, 128\)"),
    pytest.param(96, "CUDA tensor", "f32", id=r"96-\(64, 128\)"),
    # above 256 is the chunked kernels' (300 padded to 384), no limit
    pytest.param(300, "CUDA tensor", "f32",
                 id="300-chunked-padded-reaches-the-device-check"),
    pytest.param(512, "g must start on a 16-byte", "bf16 g base",
                 id="512-chunked-bf16-misaligned-g"),
    pytest.param(100, "CUDA tensor", "f16",
                 id="100-padded-reaches-the-device-check"),
    pytest.param(64, "CUDA tensor", "f32", id="64-CUDA tensor"),
    pytest.param(64, "q must start on a 16-byte", "bf16 q base",
                 id="bf16-misaligned-base"),
    pytest.param(128, "k must start on a 16-byte", "bf16 k seq stride",
                 id="bf16-misaligned-seq-stride"),
    pytest.param(64, "v must start on a 16-byte", "bf16 v head stride",
                 id="bf16-misaligned-head-stride"),
    pytest.param(128, "g must start on a 16-byte", "bf16 g base",
                 id="bf16-misaligned-g"),
    pytest.param(80, "k must start on a 16-byte", "f16 k seq stride",
                 id="f16-misaligned-seq-stride"),
    pytest.param(128, "CUDA tensor", "bf16 fused qkv",
                 id="bf16-fused-qkv-views-pass-to-the-device-check"),
    pytest.param(64, "CUDA tensor", "f32 q base",
                 id="f32-misaligned-base-passes-to-the-device-check"),
    pytest.param(64, "lse must be float32", "bf16 lse",
                 id="lse-not-float32"),
])
def test_cuda_backward_wrapper_refuses_what_the_kernels_do_not_take(
        head_dim, match, case):
    """The backward's CUDA wrapper never falls back: every head_dim goes
    on to the other checks (one the kernels do not run as it is on the
    zero-padded path, above 256 to the chunked kernels' multiple of 128);
    bf16 or f16 q, k, v or g that the tensor-core kernels cannot copy in
    16-byte vectors (a base pointer or a batch/seq/head stride off the
    16-byte grid) are refused, not copied; views of a fused qkv
    projection and float32 inputs (the FMA kernels load scalars) pass
    those checks; and CPU tensors handed to it are refused last, so they
    reach every other check."""
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16}.get(
        case[:4].strip(), torch.float32)
    qkv = _t(np.random.default_rng(2).standard_normal(
        (1, 8, 3, 2, head_dim)).astype(np.float32), dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if case != "bf16 fused qkv":
        q, k, v = (x.contiguous() for x in (q, k, v))
    g = torch.ones_like(q)
    out, lse = tattn.flash_attention_plain(q, k, v, causal=True)
    if case.endswith("q base"):
        q = _shifted(q)
    elif case.endswith("k seq stride"):
        k = _padded(k, 1)
    elif case == "bf16 v head stride":
        v = _padded(v, 2)
    elif case == "bf16 g base":
        g = _shifted(g)
    elif case == "bf16 lse":
        lse = lse.to(torch.bfloat16)
    before = (tattn.dq_launches, tattn.dkv_launches)
    with pytest.raises(ValueError, match=match):
        tattn._flash_backward_cuda(q, k, v, out, lse, g, causal=True,
                                   scale=0.125)
    assert (tattn.dq_launches, tattn.dkv_launches) == before


def test_a_newer_shared_header_makes_every_library_stale(tmp_path,
                                                         monkeypatch):
    """``_build._stale``: a library is rebuilt when it is missing, when its
    source is newer, and when any shared header ``csrc/*.cuh`` is newer,
    since every kernel source may include it."""
    from tensorflowonspark_tpu_torch.ops import _build

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    src, header = csrc / "kern.cu", csrc / "shared.cuh"
    src.write_text('#include "shared.cuh"\n')
    header.write_text("\n")
    assert _build._stale("kern")  # no library yet
    lib = build / "libkern.so"
    lib.write_bytes(b"")
    t0 = 1_700_000_000
    os.utime(src, (t0, t0))
    os.utime(header, (t0, t0))
    os.utime(lib, (t0 + 10, t0 + 10))
    assert not _build._stale("kern")
    os.utime(header, (t0 + 20, t0 + 20))
    assert _build._stale("kern")
    os.utime(header, (t0, t0))
    os.utime(src, (t0 + 20, t0 + 20))
    assert _build._stale("kern")


def test_flash_sources_build_one_library_an_instantiation(tmp_path,
                                                          monkeypatch):
    """``_build``: each flash source builds one library for every head_dim
    of ``HEAD_DIMS`` and every dtype, and one a dtype for the chunked
    kernels (``-DTFOS_HEAD_DIM=0``), from the same source with
    ``-DTFOS_HEAD_DIM`` and ``-DTFOS_DTYPE``; any other source builds one
    library of its own name.  ``build()`` runs as many nvcc's at once as
    the host has cores (two here), the backward's widest first: the
    order it starts them in, recorded where it decides it (``_start``),
    not the order two concurrent stand-ins happen to log in.  A failure
    names its library (an nvcc stand-in here: a shell script that logs
    its arguments)."""
    from tensorflowonspark_tpu_torch.ops import _build

    recipes = _build._recipes()
    want = {_build.variant(src, d, code)
            for src in _build.FLASH
            for d in (*tattn.HEAD_DIMS, _build.CHUNKED)
            for code in _build.FLASH_DTYPES} | {"rmsnorm"}
    assert set(recipes) == want and len(want) == 43
    assert recipes["flash_bwd_d80_f16"] == (
        "flash_bwd", ("-DTFOS_HEAD_DIM=80", "-DTFOS_DTYPE=2"))
    assert recipes["flash_fwd_dchunk_bf16"] == (
        "flash_fwd", ("-DTFOS_HEAD_DIM=0", "-DTFOS_DTYPE=1"))
    assert recipes["rmsnorm"] == ("rmsnorm", ())
    assert tattn.HEAD_DIMS == (32, 64, 80, 96, 128, 256)
    assert set(tattn._DTYPES.values()) == set(_build.FLASH_DTYPES)

    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    # writes its -o target, logs "<defines> <source>", fails on d96 f16
    nvcc.write_text(
        "#!/bin/sh\n"
        "out=''; defs=''; src=''\n"
        "while [ $# -gt 0 ]; do\n"
        "  case $1 in -o) out=$2; shift;; -D*) defs=\"$defs $1\";;\n"
        "  *.cu) src=$1;; esac; shift\n"
        "done\n"
        "echo \"$defs $(basename $src)\" >> " + str(log) + "\n"
        "case $defs in *HEAD_DIM=96*DTYPE=2*) echo boom; exit 1;; esac\n"
        "touch $out\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.os, "cpu_count", lambda: 2)
    started = []
    start = _build._start
    monkeypatch.setattr(_build, "_start",
                        lambda name: started.append(name) or start(name))
    names = [_build.variant("flash_fwd", 32, 1),
             _build.variant("flash_bwd", 256, 0),
             _build.variant("flash_bwd", 96, 2), "rmsnorm"]
    with pytest.raises(RuntimeError,
                       match=r"flash_bwd_d96_f16 \(exit 1\):\nboom"):
        _build.build(names)
    assert started == ["flash_bwd_d256_f32", "flash_bwd_d96_f16",
                       "flash_fwd_d32_bf16", "rmsnorm"]
    calls = log.read_text().splitlines()
    assert sorted(calls) == sorted([
        " -DTFOS_HEAD_DIM=256 -DTFOS_DTYPE=0 flash_bwd.cu",
        " -DTFOS_HEAD_DIM=96 -DTFOS_DTYPE=2 flash_bwd.cu",
        " -DTFOS_HEAD_DIM=32 -DTFOS_DTYPE=1 flash_fwd.cu", " rmsnorm.cu"])
    built = {p.name for p in (tmp_path / "build").iterdir()}
    assert built == {f"lib{n}.so" for n in names if "d96" not in n}
    log.write_text("")
    assert _build.build(names[:2]) == {}  # fresh: nothing rebuilt
    assert log.read_text() == ""
    # the chunked backward starts before every fixed head_dim
    assert sorted(want, key=_build._cost)[:3] == [
        "flash_bwd_dchunk_bf16", "flash_bwd_dchunk_f16",
        "flash_bwd_dchunk_f32"]
