"""Post-hoc analysis of the runtime's artifacts: the ring analyzers and the timeline.

Every module here is stdlib-only and standalone-loadable by path, so a
supervising process or a login node reads a run's artifacts without
importing torch:

- :mod:`.postmortem` — merges the per-rank flight rings into one verdict
  (``desync``, ``straggler``, ``oom``, ``clean``, ``inconclusive``); the
  supervisor loads it at teardown and records the verdict in its report's
  ``postmortems`` (CLI: ``python heat_tpu_torch/analysis/postmortem.py``);
- :mod:`.timeline` — telemetry JSONL, flight rings and journals merged into
  one clock-aligned Chrome trace with critical-path blame (CLI:
  ``python heat_tpu_torch/analysis/traceviz.py``);
- :mod:`.telemetry_report` — the per-rank telemetry exports merged into one
  summary, with the collective timeline, the SLO table and the step-time
  breakdown of :mod:`.stepprof`.

The reference's static linter (heatlint) has no counterpart here yet.
"""

from . import postmortem, stepprof, telemetry_report, timeline, traceviz  # noqa: F401

__all__ = ["postmortem", "stepprof", "telemetry_report", "timeline", "traceviz"]
