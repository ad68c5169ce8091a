"""Continuous-batching autoregressive decode tier.

Counterpart of ``tensorflowonspark_tpu/serving/decode``:

  - :mod:`~.kvcache` — the block-paged :class:`~.kvcache.PagedKVCache`
    (ref-counted prefix sharing through a prompt trie) and the slot
    cache :class:`~.kvcache.SlotKVCache`, pools as torch tensors;
  - :mod:`~.scheduler` — the iteration-level continuous batcher
    (:class:`~.scheduler.DecodeEngine`);
  - :mod:`~.sampling` — seeded temperature/top-k/top-p sampling, pure
    in ``(logits, params, index)``;
  - :mod:`~.loadgen` — open-loop Poisson load generator for TTFT /
    per-token SLOs, and the shared-prefix traffic mix.

The model half lives in ``models/transformer.py``.
"""

from tensorflowonspark_tpu_torch.serving.decode.loadgen import (  # noqa
    run_open_loop,
    session_route_ids,
    shared_prefix_prompts,
)
from tensorflowonspark_tpu_torch.serving.decode.sampling import (  # noqa: F401
    sample_token,
)
from tensorflowonspark_tpu_torch.serving.decode.scheduler import (  # noqa
    DecodeEngine,
    DecodeSpec,
    PendingSession,
)
