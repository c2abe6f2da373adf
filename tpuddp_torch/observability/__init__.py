"""Typed telemetry of a training run — the counterpart of
``tpuddp/observability``: the history schema and its writer, the step
recorder, profiling and the bundle an epoch loop wires through its passes
(part 1), and the live plane (part 2): the crash flight recorder
(:mod:`~tpuddp_torch.observability.flight`), the ``/metrics`` exporter
(:mod:`~tpuddp_torch.observability.exporter`), the cross-host shards and
the straggler detector (:mod:`~tpuddp_torch.observability.aggregate`) and
the causal tracing plane (:mod:`~tpuddp_torch.observability.trace`), set by
a settings file's ``observability`` block
(:func:`tpuddp_torch.config.resolve_observability`), and the autotuning
advisor (:mod:`~tpuddp_torch.observability.advisor`; ``advisor: true``
arms its ``pending_tune`` flight context).
"""

from tpuddp_torch.observability.metrics import (  # noqa: F401
    CommBytesCounter, MetricsWriter, json_sanitize,
)
from tpuddp_torch.observability.schema import (  # noqa: F401
    SCHEMA_VERSION, config_hash, make_run_meta, stamp, validate_flight_file,
    validate_history_file, validate_history_records, validate_record, validate_trace_file,
)
from tpuddp_torch.observability.telemetry import RunTelemetry  # noqa: F401
