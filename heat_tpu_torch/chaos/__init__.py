"""Deterministic chaos campaign engine (stdlib-only, torch-free).

Sweeps pseudo-random fault schedules drawn from ``faults.catalog()``
against real supervised multi-process workloads, judges every run with
invariant oracles, and auto-shrinks failing schedules to minimal
``CHAOS-REPRO`` reproducers.

Layout:

- ``schedule``   — seeded fault-schedule generation, tokens, repro lines
- ``worker``     — the fast-tier supervised harness workload
- ``oracles``    — the invariant suite judging a finished run
- ``engine``     — Supervisor-driven runner, campaign journal, verdicts
- ``shrink``     — greedy delta-debugging to a re-confirmed minimum
- ``scenarios``  — the five full-tier scenarios as declarative specs
- ``world``      — the supervised worlds of the port the scenarios launch
- ``campaign``   — the command line (``python heat_tpu_torch/chaos/campaign.py``)

Every submodule is also standalone-loadable by path (the campaign runner and
the supervisor host import no torch; only ``world``'s workers do, in their
own processes).
"""

from . import engine, oracles, scenarios, schedule, shrink  # noqa: F401

__all__ = ["engine", "oracles", "scenarios", "schedule", "shrink"]
