"""The input pipeline: a lazy dataset graph and the data service.

An own copy of ``tensorflowonspark_tpu/data``: sources, transforms and
device staging over columnar blocks (``data.pipeline``), with the
feed's ``marker.ColumnChunk`` as the wire format, and a disaggregated
data service (``data.service``) that runs the pipeline on the engine's
executors and feeds the trainers, with static (rank-strided) or dynamic
(first-come-first-served splits, ``data.splits``) dispatch.

Quick start::

    from tensorflowonspark_tpu_torch import data

    pipe = (data.from_tfrecords("/data/train")
                .interleave(cycle_length=4)
                .shuffle(buffer_size=10_000, seed=42)
                .parallel_map(normalize, num_workers=4)
                .batch(256, drop_remainder=True)
                .prefetch(2))
    for block in pipe.blocks():          # host: {name: ndarray[b, ...]}
        ...
    for staged in pipe.to_device():      # the card, double-buffered
        ...

The service (``cluster.run(..., data_workers=N)``)::

    cluster = TFCluster.run(engine, main_fun, args, num_executors,
                            input_mode=InputMode.SPARK, data_workers=2,
                            data_dispatch="static")   # or "dynamic"
    cluster.train(pipe, num_epochs=4)    # the workers run the pipeline

Knobs: ``TFOS_DATA_WORKERS`` (the default worker count),
``TFOS_DATA_DISPATCH``, ``TFOS_DATA_SPLIT_BLOCKS``,
``TFOS_DATA_PREFETCH`` (the default prefetch depth).
"""

from tensorflowonspark_tpu_torch.data.pipeline import (  # noqa: F401
    Pipeline,
    block_len,
    block_to_chunk,
    from_arrays,
    from_dataset,
    from_tfrecords,
)
from tensorflowonspark_tpu_torch.data.service import DataService  # noqa: F401

__all__ = [
    "Pipeline",
    "DataService",
    "from_tfrecords",
    "from_dataset",
    "from_arrays",
    "block_to_chunk",
    "block_len",
]
