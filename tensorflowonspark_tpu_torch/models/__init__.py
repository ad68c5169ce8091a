"""Models of the port (counterpart of ``tensorflowonspark_tpu/models``)."""
