"""The reference's ``tests/test_flightrec.py``, run against heat_tpu_torch.utils.flightrec.

Every test of that file runs here with ``heat_tpu`` read as
``heat_tpu_torch`` (its imports, module paths and the ``ht`` fixture), on
the CPU at world size 1, so the port's copy is held to the reference's own
cases.  ``NOT_PORTED`` names each test left out and why.
"""

import pathlib
import re

import pytest

import heat_tpu_torch as _htt

_REF = pathlib.Path(__file__).with_name("test_flightrec.py")
_SRC = re.sub(r"\bheat_tpu\b(?!_torch)", "heat_tpu_torch", _REF.read_text())
exec(compile(_SRC, f"{_REF.name}[heat_tpu_torch]", "exec"), globals())

REASONS = {
    "DISPATCH": "per-op dispatch hooks (`core._operations`): the port instruments no op dispatch",
    "W1": "needs a collective at world size 1: the reference's 8-device mesh runs one there, the port's world of one process none (the port's collectives are stamped, accounted and guarded at 2 gloo ranks in test_torch_runtime_mp.py)",
}
NOT_PORTED = {
    "TestStamping::test_collectives_stamped_with_fingerprint": "W1",
    "TestStamping::test_disabled_is_noop_and_unhooked": "DISPATCH",
    "TestStamping::test_dispatch_records_ride_along": "DISPATCH",
    "TestStamping::test_heartbeat_carries_seq": "W1",
    "TestStamping::test_seq_monotone_across_collectives": "W1",
    "TestTraceStamping::test_staged_collective_through_account_bytes_carries_tid": "W1",
}
for _test, _why in NOT_PORTED.items():
    _cls, _, _fn = _test.partition("::")
    assert _why in REASONS and hasattr(globals()[_cls], _fn), _test
    delattr(globals()[_cls], _fn)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = _htt.get_device()
    _htt.use_device("cpu")
    yield
    _htt.use_device(prev)


@pytest.fixture(name="ht")
def _port_ht():
    return _htt
