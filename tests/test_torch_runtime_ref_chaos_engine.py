"""The reference's ``tests/test_chaos_engine.py``, run against heat_tpu_torch.chaos.

Every test of that file runs here with ``heat_tpu`` read as
``heat_tpu_torch`` and the reference's tools read as the port's copies
(``scripts/postmortem.py`` as ``heat_tpu_torch/analysis/postmortem.py``,
``scripts/chaoscamp.py`` as ``heat_tpu_torch/chaos/campaign.py``), so the
port's schedule generator, shrinker, journal, oracles' read-side hooks,
scenario specs and one real supervised engine run are held to the
reference's own cases; the reference's marks stay (``TestCampaignE2E`` is
``slow``).  Two of its lines read the reference's launch shape and are
read as the port's (``PORT_READINGS``): a world's shape is its rank count,
with no devices per process, and the post-mortem scenarios' collective is
``scenarios.PM_OP``.  No test is left out.
"""

import pathlib
import re

from heat_tpu_torch.chaos import scenarios as _scenarios

_REF = pathlib.Path(__file__).with_name("test_chaos_engine.py")
_SRC = re.sub(r"\bheat_tpu\b(?!_torch)", "heat_tpu_torch", _REF.read_text())
PORT_READINGS = (
    ('os.path.join(REPO, "scripts", "postmortem.py")', 'os.path.join(REPO, "heat_tpu_torch", "analysis", "postmortem.py")'),
    ("python scripts/chaoscamp.py --replay ", "python heat_tpu_torch/chaos/campaign.py --replay "),
    ('spec["n_proc"] >= 1 and spec["devs_per_proc"] >= 1', 'spec["n_proc"] >= 1'),
    ("stuck at seq 7 resplit", f"stuck at seq 7 {_scenarios.PM_OP}"),
    ("seq=7 op=resplit", f"seq=7 op={_scenarios.PM_OP}"),
    ("rank=1 op=resplit seq=7", f"rank=1 op={_scenarios.PM_OP} seq=7"),
)
for _old, _new in PORT_READINGS:
    assert _old in _SRC, _old
    _SRC = _SRC.replace(_old, _new)
exec(compile(_SRC, f"{_REF.name}[heat_tpu_torch]", "exec"), globals())
