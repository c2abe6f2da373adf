"""The autotuning plane — the advisor's actuators (schema v12); the
counterpart of ``tpuddp/tune/``.

``tpuddp_torch/observability/advisor.py`` is the read-only evidence engine;
this package turns its recommendations into verified changes:

- :mod:`tpuddp_torch.tune.probe`  — A/B delta arithmetic + the
  schema-validated ``TUNE_r*.json`` report (predicted vs measured per rule,
  endorsement verdicts). ``python -m tpuddp_torch.tune`` is its CLI.
- :mod:`tpuddp_torch.tune.online` — the fleet tuner: applies at most one
  endorsed knob change per job per cooldown through the controller's
  drain-and-relaunch contract, measures the post-change window from the
  job's own history, and reverts automatically when the measured delta
  regresses. Every action lands as a typed ``tune_action`` history event
  and a ``tpuddp_tune_*`` /metrics counter.
"""

from tpuddp_torch.tune.probe import (  # noqa: F401
    HIGHER_BETTER,
    LOWER_BETTER,
    build_tune_report,
    delta_pct,
    endorse,
    make_result_row,
    next_tune_path,
)
from tpuddp_torch.tune.online import (  # noqa: F401
    FleetTuner,
    TunePolicy,
    endorsed_rules_from_report,
)
