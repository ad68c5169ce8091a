"""Parallelism library: meshes, shardings, and parallel layers.

Counterpart of ``tensorflowonspark_tpu/parallel``: one
``torch.distributed`` ``DeviceMesh`` with the JAX package's named axes,
``DTensor`` placements for parameters and batches, and the parallel
layers (ring, zigzag and Ulysses attention, the pipeline) over the
mesh's per-axis process groups, with autograd collectives
(:mod:`parallel.collectives`).  :mod:`parallel.launch` starts a pool of
ranks on one host; :mod:`parallel.dryrun` runs the multi-rank dry run.
"""

from tensorflowonspark_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    local_to_global,
    make_mesh,
    replicated,
    sharded,
)
from tensorflowonspark_tpu_torch.parallel.ring import (  # noqa: F401
    inverse_permutation,
    ring_attention,
    sequence_parallel_attention,
    ulysses_attention,
    zigzag_permutation,
    zigzag_ring_attention,
)
from tensorflowonspark_tpu_torch.parallel.sharding import (  # noqa: F401
    apply_shardings,
    batch_sharding,
    fsdp_sharding,
    replicated_sharding,
    shard_train_state,
)
from tensorflowonspark_tpu_torch.parallel.pipeline_parallel import (  # noqa
    pipeline_apply,
    stack_stage_params,
    stage_sharding,
)
