"""Package metadata (parity: reference setup.py — version, minimal deps)."""

from setuptools import find_packages, setup

setup(
    name="tensorflowonspark_tpu",
    version="0.1.0",
    description=(
        "TPU-native cluster-federation framework: bring up distributed "
        "JAX/XLA training from a data-engine scheduler and stream "
        "partitions into the TPU infeed."
    ),
    packages=find_packages(include=["tensorflowonspark_tpu*"]),
    # the PyTorch port builds its CUDA kernels, its feed ring, its
    # TFRecord codec and its marshal from these sources at first use
    package_data={"tensorflowonspark_tpu_torch": [
        "ops/csrc/*.cu", "ops/csrc/*.cuh", "native/*.cpp", "native/*.c"]},
    python_requires=">=3.10",
    install_requires=["cloudpickle", "numpy"],
    extras_require={
        "tpu": ["jax", "optax", "orbax-checkpoint"],
        "spark": ["pyspark>=3.0"],
        # remote record IO / checkpoints on gs:// (other schemes: install
        # the matching fsspec driver, e.g. s3fs, pyarrow for hdfs)
        "fs": ["fsspec", "gcsfs"],
    },
    entry_points={
        "console_scripts": [
            # parity: the reference's spark-submit Inference.scala CLI
            "tfos-inference=tensorflowonspark_tpu.inference:main",
            # the PyTorch/CUDA port's batch-inference CLI
            "tfos-inference-torch=tensorflowonspark_tpu_torch.inference:main",
            # online serving (docs/serving.md) — no reference equivalent
            "tfos-serve=tensorflowonspark_tpu.serving.server:main",
            # the PyTorch/CUDA port's online serving
            "tfos-serve-torch=tensorflowonspark_tpu_torch.serving.server:main",
            # live cluster view (docs/observability.md)
            "tfos-top=tensorflowonspark_tpu.obs.top:main",
            # flight-recorder dump assembly (docs/telemetry.md)
            "tfos-postmortem=tensorflowonspark_tpu.obs.postmortem:main",
            # the PyTorch/CUDA port's cluster view and postmortem
            "tfos-top-torch=tensorflowonspark_tpu_torch.obs.top:main",
            "tfos-postmortem-torch="
            "tensorflowonspark_tpu_torch.obs.postmortem:main",
        ],
    },
)
