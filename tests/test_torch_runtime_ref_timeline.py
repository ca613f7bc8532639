"""The reference's ``tests/test_timeline.py``, run against heat_tpu_torch.analysis.timeline and its CLI.

Every test of that file runs here with ``heat_tpu`` read as
``heat_tpu_torch`` and the reference's command-line tools read as the
port's copies (``scripts/traceviz.py`` as ``heat_tpu_torch/analysis/traceviz.py``,
``scripts/telemetry_report.py`` as ``heat_tpu_torch/analysis/telemetry_report.py``),
so the port's timeline is held to the reference's own cases.  No test is
left out.
"""

import pathlib
import re

_REF = pathlib.Path(__file__).with_name("test_timeline.py")
_SRC = re.sub(r"\bheat_tpu\b(?!_torch)", "heat_tpu_torch", _REF.read_text())
for _old, _new in (('os.path.join(REPO, "scripts", "traceviz.py")',
                    'os.path.join(REPO, "heat_tpu_torch", "analysis", "traceviz.py")'),
                   ('"scripts/telemetry_report.py"', '"heat_tpu_torch/analysis/telemetry_report.py"')):
    assert _old in _SRC, _old
    _SRC = _SRC.replace(_old, _new)
exec(compile(_SRC, f"{_REF.name}[heat_tpu_torch]", "exec"), globals())
