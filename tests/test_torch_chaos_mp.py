"""The post-mortem verdicts end to end on the CPU: supervised gloo worlds of the port.

``hang-straggler-verdict`` (2 ranks) and ``desync-minority-verdict``
(3 ranks) of ``heat_tpu_torch.chaos.scenarios`` run through
``chaos/world.py``: rank 1 hangs on a ``comm.collective`` fault, or
issues one extra collective; heartbeat staleness tears the world down;
the supervisor loads ``analysis/postmortem.py`` at teardown and its report
carries the verdict under ``postmortems``: the straggler rank 1 at the seq
it announced before hanging, or the desync at the seq it announced,
rank 1 the minority.  Each scenario is one spawn, ~20 s.
"""

import json
import re

import pytest

from heat_tpu_torch.chaos import scenarios

TIMEOUT_S = 240


def _report(out: str) -> dict:
    """The supervisor's report the launcher prints after giving up."""
    at = out.index("SUPERVISOR GAVE UP; diagnostic report:")
    return json.JSONDecoder().raw_decode(out[out.index("{", at):])[0]


@pytest.mark.parametrize("name, announced, check", [
    ("hang-straggler-verdict", r"\[1\] PM-HANG expect_seq=(\d+)",
     lambda v, seq: v["verdict"] == "straggler" and v["straggler"]["rank"] == 1 and v["straggler"]["seq"] == seq
     and v["straggler"]["op"] == scenarios.PM_OP),
    ("desync-minority-verdict", r"\[1\] PM-DESYNC expect_seq=(\d+)",
     lambda v, seq: v["verdict"] == "desync" and v["first_divergent_seq"] == seq and v["deviating_ranks"] == [1]),
], ids=["hang-straggler", "desync-minority"])
def test_supervisor_report_carries_the_verdict(name, announced, check):
    proc = scenarios.run_scenario(name, timeout=TIMEOUT_S, device="cpu")
    assert scenarios.check_scenario(name, proc) == [], proc.stdout[-4000:] + proc.stderr[-2000:]
    seq = int(re.search(announced, proc.stdout).group(1))
    pms = _report(proc.stdout)["postmortems"]
    assert len(pms) == 1 and pms[0]["epoch"] == 0, pms
    assert check(pms[0], seq), pms[0]
