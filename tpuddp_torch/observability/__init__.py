"""Typed telemetry of a training run — the counterpart of
``tpuddp/observability`` (part 1: the history schema, its writer, the step
recorder, profiling and the bundle an epoch loop wires through its passes).

The live plane (the exporter, pod aggregation, the flight recorder and the
tracing plane) is ROADMAP.md Queue 1 item 8 "observability, part 2": a
settings file's ``observability`` block is refused until then.
"""

from tpuddp_torch.observability.metrics import (  # noqa: F401
    CommBytesCounter, MetricsWriter, json_sanitize,
)
from tpuddp_torch.observability.schema import (  # noqa: F401
    SCHEMA_VERSION, config_hash, make_run_meta, stamp, validate_history_file,
    validate_history_records, validate_record,
)
from tpuddp_torch.observability.telemetry import RunTelemetry  # noqa: F401
