"""tpuddp_torch.serving.decode — token-level autoregressive serving, the
counterpart of ``tpuddp/serving/decode``:

- :mod:`cache`  — the paged KV-cache pool: one device-resident
  ``(layers, blocks, block_size, heads, head_dim)`` K/V pool pair per
  replica, per-sequence block tables, free-list allocation, occupancy;
- :mod:`stats`  — token-level SLO metrics (tokens/s, time to first token,
  inter-token latency, KV occupancy) as typed ``decode_stats`` rows;
- :mod:`engine` — :class:`DecodeEngine`: continuous batching at token
  granularity, the prefill/decode split (bucketed eager prefill and one
  ``(max_slots, 1)`` step, a CUDA-graph replay on a card), host sampling,
  per-token streaming, session failover and the drain contract.

The model side is :mod:`tpuddp_torch.models.transformer` (``prefill`` and
``decode_step``); the config side the ``serving.decode`` block
(:data:`tpuddp_torch.config.DECODE_DEFAULTS`).
"""

from tpuddp_torch.serving.decode.cache import PagedKVCache  # noqa: F401
from tpuddp_torch.serving.decode.engine import (  # noqa: F401
    DecodeEngine,
    DecodeReplica,
    DecodeRequest,
    StreamedResult,
)
from tpuddp_torch.serving.decode.stats import DecodeStats  # noqa: F401

__all__ = [
    "DecodeEngine",
    "DecodeReplica",
    "DecodeRequest",
    "DecodeStats",
    "PagedKVCache",
    "StreamedResult",
]
