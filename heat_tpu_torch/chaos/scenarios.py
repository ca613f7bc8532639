"""The five chaos scenarios as declarative specs.

Each full-tier chaos scenario is expressed here as DATA: the launch shape
of a supervised world of :mod:`.world` (mode, rank count, environment)
plus the attestation contract the run must print.  :func:`run_scenario`
launches a spec through ``heat_tpu_torch/chaos/world.py`` (the same
subprocess worlds, the same markers) and :func:`check_scenario` judges the
finished run against it.

Why data, not code: a declarative spec is diffable (the whole
fault-injection surface of a scenario is visible in one dict), greppable
(logs name the spec), and replayable from the command line
(``heat_tpu_torch/chaos/campaign.py --scenario kill-resume-train``).

The contract language:

- ``expect_rc``      — ``"zero"`` or ``"nonzero"``
- ``expect``         — literal substrings that must appear in stdout
- ``expect_re``      — regexes that must match stdout
- ``derived``        — two-stage assertions ``[capture_re, template]``:
  the capture's group(1) is substituted into the template (as ``{0}``)
  and the result must appear literally.  This is how the hang/desync
  scenarios assert the post-mortem names the EXACT seq the victim
  announced (``PM-HANG expect_seq=N`` → ``verdict=straggler … seq=N``).
- ``forbid``         — substrings that must NOT appear

The specs are the reference's, with the port's rank counts (``n_proc``:
the world's processes, each one rank) and two differences: the
post-mortem worlds' ``resplit_`` flips are accounted as the collective
that carries them (``PM_OP``, the op the verdicts name), and their
heartbeat timeout is shorter (a torch rank comes up in seconds).

Stdlib-only and standalone-loadable; the launcher module is spec-loaded,
so this file never imports torch either.
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys
import threading
from typing import Dict, List, Optional

__all__ = ["SCENARIOS", "PM_OP", "scenario", "run_scenario", "check_scenario"]

_HERE = os.path.dirname(os.path.abspath(__file__))
# the op the post-mortem worlds' resplit_ flips are stamped as: the port
# accounts a split-to-split resplit as the Alltoall that carries it
PM_OP = "Alltoall"


_WORLD_LOCK = threading.Lock()  # scenarios may launch from several threads at once


def _world():
    with _WORLD_LOCK:
        for name in ("heat_tpu_torch.chaos.world", "heat_chaos_world"):
            if name in sys.modules:
                return sys.modules[name]
        spec = importlib.util.spec_from_file_location("heat_chaos_world", os.path.join(_HERE, "world.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        return mod


# ---------------------------------------------------------------------- #
# the five scenarios
# ---------------------------------------------------------------------- #
SCENARIOS: Dict[str, dict] = {
    # SIGKILL one rank mid-DASO-training; the supervisor restarts the world
    # and training resumes from the newest verified checkpoint (killed at
    # step 5, checkpoint every 3 -> both ranks resume at step 3 and reach
    # the target).
    "kill-resume-train": {
        "mode": "train",
        "n_proc": 2,
        "timeout": 700,
        "extra_env": {
            "MPDRYRUN_TARGET_STEPS": 12,
            "MPDRYRUN_CKPT_EVERY": 3,
            "MPDRYRUN_FAULT_RANK": 1,
            "MPDRYRUN_FAULT_SPEC": "proc.exit:exit=5",
            "MPDRYRUN_STEP_DELAY": 0.1,
            "MPDRYRUN_RESTARTS": 2,
        },
        "expect_rc": "zero",
        "expect": [
            "rank 1 died with exit code -9",
            "SUPERVISOR restarts=1 generations=2",
            "[0] RESUMED epoch=1 step=3 ok=True",
            "[1] RESUMED epoch=1 step=3 ok=True",
            "[0] TRAIN-OK steps=12",
            "[1] TRAIN-OK steps=12",
            "watchdog.kills",
            "TELEMETRY-MERGED ranks=2",
        ],
        "expect_re": [
            r"STEP-OVERLAP kind=daso\.step steps=\d+ overlap=\d\.\d+",
        ],
    },
    # SIGKILL one serving rank mid-queue; journal replay requeues the
    # in-flight jobs exactly once and the attestation proves zero lost and
    # unbroken trace chains across the restart.
    "serve-sigkill-mid-queue": {
        "mode": "serve",
        "n_proc": 2,
        "timeout": 700,
        "extra_env": {
            "MPDRYRUN_FAULT_RANK": 1,
            "MPDRYRUN_FAULT_SPEC": "sched.dispatch:exit=4",
            "MPDRYRUN_RESTARTS": 2,
        },
        "expect_rc": "zero",
        "expect": [
            "rank 1 died with exit code -9",
            "SUPERVISOR restarts=1 generations=2",
            "[0] SERVE-OK",
            "[1] SERVE-OK",
            "TELEMETRY-MERGED ranks=2",
            "SCHED-TRACE-CONTINUITY jobs=20 ok=True",
            "causal timeline for trace",
        ],
        "expect_re": [
            r"SCHED jobs=20 done=18 requeued=[1-9]\d* shed=2 failed=0 lost=0",
        ],
        # SPMD lockstep recovery: every rank requeued the SAME set the
        # journal attestation counted (a divergent requeue would desync)
        "derived": [
            [
                r"SCHED jobs=20 done=18 requeued=(\d+)",
                "[0] SCHED-RECOVERED epoch=1 requeued={0}",
            ],
            [
                r"SCHED jobs=20 done=18 requeued=(\d+)",
                "[1] SCHED-RECOVERED epoch=1 requeued={0}",
            ],
        ],
    },
    # One rank wedges on an injected collective hang; the supervisor's
    # heartbeat staleness converts the wedge into teardown and the ring
    # post-mortem names the straggler at the exact seq the victim announced
    # before hanging.
    "hang-straggler-verdict": {
        "mode": "postmortem",
        "n_proc": 2,
        "timeout": 700,
        "extra_env": {
            "MPDRYRUN_HANG_RANK": 1,
            "MPDRYRUN_CHAOS_AT": 3,
            "MPDRYRUN_HB_TIMEOUT": 12,
        },
        "expect_rc": "nonzero",  # a wedged world is a FAILED run
        "expect": ["SUPERVISOR GAVE UP"],
        "expect_re": [
            rf"heartbeat stale .*stuck at seq \d+ {PM_OP}",
            r"TRACE-EXPORT events=\d+ ranks=\d+ out=",
        ],
        "derived": [
            [
                r"\[1\] PM-HANG expect_seq=(\d+)",
                f"POSTMORTEM epoch=0 verdict=straggler rank=1 seq={{0}} op={PM_OP}",
            ],
            [
                r"\[1\] PM-HANG expect_seq=(\d+)",
                f"CRITICAL-PATH kind=collective rank=1 op={PM_OP} seq={{0}}",
            ],
        ],
    },
    # One of three ranks issues a rank-conditional EXTRA collective; the
    # analyzer names the first divergent seq and convicts the minority
    # fingerprint by majority vote.
    "desync-minority-verdict": {
        "mode": "postmortem",
        "n_proc": 3,
        "timeout": 700,
        "extra_env": {
            "MPDRYRUN_DESYNC_RANK": 1,
            "MPDRYRUN_CHAOS_AT": 3,
            "MPDRYRUN_HB_TIMEOUT": 12,
        },
        "expect_rc": "nonzero",
        "expect": ["SUPERVISOR GAVE UP"],
        "derived": [
            [
                r"\[1\] PM-DESYNC expect_seq=(\d+)",
                "POSTMORTEM epoch=0 verdict=desync seq={0} ranks=1",
            ],
        ],
    },
    # SIGKILL an entire world of a two-world federation mid-queue; the
    # survivor absorbs the stolen jobs and the journal-derived attestation
    # proves zero loss (12 jobs + the shed giant accounted).
    "fed-world-kill": {
        "mode": "fed",
        "n_proc": 2,
        "timeout": 700,
        "extra_env": {"MPDRYRUN_JOBS": 12},
        "expect_rc": "zero",
        "expect": [
            "submitted=12",
            "FED-SHED id=giant reason=mem_infeasible http=429",
            "FED worlds=2 lost=0 jobs=13",
        ],
        "expect_re": [
            r"FED-QUARANTINED world=w1 stolen=[1-9]\d*",
            r"FED-HEALTHZ-DEGRADED http=200 healthy=1 quarantined=1",
            r"FED-RESIZE world=w0 ranks=1->\d+ queue=\d+",
            r"FED-RESULT id=\S+ http=200 digest=",
        ],
    },
}


def scenario(name: str) -> dict:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r} (have: {', '.join(sorted(SCENARIOS))})"
        )


def run_scenario(name: str, *, timeout: Optional[float] = None, device: Optional[str] = None,
                 env: Optional[dict] = None):
    """Launch one spec through the supervised worlds of :mod:`.world`, on
    ``device`` ("gpu": every rank on the one card, or "cpu"; None:
    ``MPDRYRUN_DEVICE`` of the environment, else the card),
    with ``env`` over the spec's environment (a longer heartbeat timeout
    where ranks take longer to come up).  Returns the ``CompletedProcess``;
    judge it with :func:`check_scenario`."""
    spec = scenario(name)
    return _world().launch(
        timeout=timeout if timeout is not None else spec["timeout"],
        n_proc=spec["n_proc"],
        mode=spec["mode"],
        extra_env={**spec["extra_env"], **(env or {})},
        device=device,
    )


def check_scenario(name: str, proc) -> List[str]:
    """Evaluate a finished run against its spec's attestation contract.
    Returns the list of violated clauses — empty means the scenario
    reproduced; tests assert ``check_scenario(...) == []`` so a failure
    names every broken clause at once."""
    spec = scenario(name)
    out = proc.stdout
    bad: List[str] = []
    rc = proc.returncode
    if spec["expect_rc"] == "zero":
        if rc != 0:
            bad.append(f"expected rc==0, got {rc}")
        marker = _world().PASS_MARKER
        if marker not in out:
            bad.append(f"missing pass marker {marker!r}")
    elif rc == 0:
        bad.append("expected nonzero rc, got 0")
    for lit in spec.get("expect", ()):
        if lit not in out:
            bad.append(f"missing literal {lit!r}")
    for pat in spec.get("expect_re", ()):
        if not re.search(pat, out):
            bad.append(f"no match for /{pat}/")
    for capture, template in spec.get("derived", ()):
        m = re.search(capture, out)
        if not m:
            bad.append(f"derived capture /{capture}/ never matched")
            continue
        want = template.format(m.group(1))
        if want not in out:
            bad.append(f"derived assertion missing: {want!r}")
    for lit in spec.get("forbid", ()):
        if lit in out:
            bad.append(f"forbidden output present: {lit!r}")
    return bad
