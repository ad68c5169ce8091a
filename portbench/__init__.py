"""The benchmark of the PyTorch/CUDA port (``tensorflowonspark_tpu_torch``).
Entry point: ``portbench/run.py``."""
