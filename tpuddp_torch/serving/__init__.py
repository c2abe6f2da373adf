"""tpuddp_torch.serving — the counterpart of ``tpuddp/serving``: the
continuous-batching multi-tenant inference engines.

Each local device holds a whole copy of the model and runs a dispatch loop
of its own, on a CUDA stream of its own, so the devices serve as a pool of
independently schedulable replicas:

- :mod:`queue`     — thread-safe bounded request queue with per-tenant
  quotas, round-robin fairness and reject-with-reason admission;
- :mod:`scheduler` — coalesces variable-size requests into padded
  power-of-two row buckets (:mod:`tpuddp_torch.utils.batching`);
- :mod:`replica`   — the replicas, from a seeded init or a checkpoint of
  either package through the integrity path;
- :mod:`stats`     — SLO metrics as typed ``serving_stats`` and ``event``
  rows of ``history.jsonl``;
- :mod:`survive`   — probation, retry budgets, deadlines, typed failure;
- :mod:`engine`    — :class:`ServingEngine`, the request engine.

Token traffic has its own sub-package, :mod:`tpuddp_torch.serving.decode`:
the paged KV cache, token-level continuous batching and streaming over the
transformers of :mod:`tpuddp_torch.models.transformer`.

``python -m tpuddp_torch.serving --settings <yaml>`` stands an engine up
from a settings file's ``serving`` block (``--decode``: the token engine
from its ``serving.decode`` block).

Importing the package sets ``$CUBLAS_WORKSPACE_CONFIG`` to ``:4096:8``
unless it is set: cuBLAS is reproducible across concurrent streams only
with a fixed workspace, and the engines' replicas launch from one stream
each. It takes effect where the package is imported before cuBLAS's first
call, as the entry point does; on an H100 it is PyTorch's default size.
"""

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from tpuddp_torch.serving.decode import (  # noqa: F401,E402
    DecodeEngine,
    DecodeRequest,
    DecodeStats,
    PagedKVCache,
    StreamedResult,
)
from tpuddp_torch.serving.engine import ServingEngine  # noqa: F401,E402
from tpuddp_torch.serving.queue import (  # noqa: F401,E402
    AdmissionError,
    Request,
    RequestQueue,
    ServedResult,
)
from tpuddp_torch.serving.replica import Replica, ReplicaPool  # noqa: F401,E402
from tpuddp_torch.serving.scheduler import Batch, BatchScheduler  # noqa: F401,E402
from tpuddp_torch.serving.stats import ServingStats  # noqa: F401,E402
from tpuddp_torch.serving.survive import (  # noqa: F401,E402
    NoHealthyReplicaError,
    RetryBudget,
    SurvivePolicy,
)

__all__ = [
    "AdmissionError",
    "NoHealthyReplicaError",
    "RetryBudget",
    "SurvivePolicy",
    "Batch",
    "BatchScheduler",
    "DecodeEngine",
    "DecodeRequest",
    "DecodeStats",
    "PagedKVCache",
    "StreamedResult",
    "Replica",
    "ReplicaPool",
    "Request",
    "RequestQueue",
    "ServedResult",
    "ServingEngine",
    "ServingStats",
]
