"""The reference's ``tests/test_monitor.py``, run against heat_tpu_torch.utils.monitor.

Every test of that file runs here with ``heat_tpu`` read as
``heat_tpu_torch`` (its imports, module paths and the ``ht`` fixture), on
the CPU at world size 1, so the port's copy is held to the reference's own
cases.  ``NOT_PORTED`` names each test left out and why.
"""

import pathlib
import re

import pytest

import heat_tpu_torch as _htt

_REF = pathlib.Path(__file__).with_name("test_monitor.py")
_SRC = re.sub(r"\bheat_tpu\b(?!_torch)", "heat_tpu_torch", _REF.read_text())
exec(compile(_SRC, f"{_REF.name}[heat_tpu_torch]", "exec"), globals())


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = _htt.get_device()
    _htt.use_device("cpu")
    yield
    _htt.use_device(prev)


@pytest.fixture(name="ht")
def _port_ht():
    return _htt
