"""The reference's ``tests/test_health.py``, run against heat_tpu_torch.utils.health, the port's supervisor and the deadline watchdog.

Every test of that file runs here with ``heat_tpu`` read as
``heat_tpu_torch`` (its imports, module paths and the ``ht`` fixture), on
the CPU at world size 1, so the port's copy is held to the reference's own
cases.  ``NOT_PORTED`` names each test left out and why.
"""

import pathlib
import re

import pytest

import heat_tpu_torch as _htt

_REF = pathlib.Path(__file__).with_name("test_health.py")
_SRC = re.sub(r"\bheat_tpu\b(?!_torch)", "heat_tpu_torch", _REF.read_text())
exec(compile(_SRC, f"{_REF.name}[heat_tpu_torch]", "exec"), globals())

REASONS = {
    "JAX": "drives the JAX package's own surface (`_jarray`, `shard_map`, `host_fetch`, jitted or donated optimizer state, module `init`/`apply`), which the port does not have",
}
NOT_PORTED = {
    "TestGuardedCollectives::test_expired_deadline_refuses_staging": "JAX",
    "TestGuardedCollectives::test_host_fetch_all_batches": "JAX",
    "TestGuardedCollectives::test_injected_hang_at_staging_trips": "JAX",
    "TestGuardedCollectives::test_injected_hang_on_host_fetch_trips": "JAX",
    "TestGuardedCollectives::test_injected_hang_on_wait_trips": "JAX",
    "TestGuardedCollectives::test_wait_passthrough_without_deadline": "JAX",
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
