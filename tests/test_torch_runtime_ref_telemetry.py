"""The reference's ``tests/test_telemetry.py``, run against heat_tpu_torch.utils.telemetry and profiler.

Every test of that file runs here with ``heat_tpu`` read as
``heat_tpu_torch`` (its imports, module paths and the ``ht`` fixture), on
the CPU at world size 1, so the port's copy is held to the reference's own
cases.  ``NOT_PORTED`` names each test left out and why.
"""

import pathlib
import re

import pytest

import heat_tpu_torch as _htt

_REF = pathlib.Path(__file__).with_name("test_telemetry.py")
_SRC = re.sub(r"\bheat_tpu\b(?!_torch)", "heat_tpu_torch", _REF.read_text())
exec(compile(_SRC, f"{_REF.name}[heat_tpu_torch]", "exec"), globals())

REASONS = {
    "CACHE": "the JAX program cache: the port caches no programs, so `cache_stats` is empty and no `cache.*` counters exist",
    "DISPATCH": "per-op dispatch hooks (`core._operations`): the port instruments no op dispatch",
    "JAX": "drives the JAX package's own surface (`_jarray`, `shard_map`, `host_fetch`, jitted or donated optimizer state, module `init`/`apply`), which the port does not have",
    "W1": "needs a collective at world size 1: the reference's 8-device mesh runs one there, the port's world of one process none (the port's collectives are stamped, accounted and guarded at 2 gloo ranks in test_torch_runtime_mp.py)",
}
NOT_PORTED = {
    "TestCollectiveAccounting::test_allreduce_traffic_factor": "JAX",
    "TestCollectiveAccounting::test_gather_fallback_counter": "JAX",
    "TestCollectiveAccounting::test_noop_resplit_not_counted": "W1",
    "TestCollectiveAccounting::test_payload_nbytes_on_tracers": "JAX",
    "TestCollectiveAccounting::test_resplit_bytes_and_calls": "W1",
    "TestCollectiveAccounting::test_scan_exscan_prod_attribution": "JAX",
    "TestCollectiveAccounting::test_summa_matmul_shows_send_bytes": "W1",
    "TestDispatchInstrumentation::test_disabled_dispatch_adds_nothing": "DISPATCH",
    "TestDispatchInstrumentation::test_dispatch_tail_records_op_and_cache_state": "DISPATCH",
    "TestOptimInstrumentation::test_daso_step_histogram": "JAX",
    "TestOptimInstrumentation::test_eager_step_histogram_and_guard_provider": "JAX",
    "TestOptimInstrumentation::test_train_step_wrapper_keeps_lower": "JAX",
    "TestReportAndExport::test_report_merges_counters_hists_spans": "CACHE",
    "TestTracing::test_dispatch_records_inherit_the_ambient_trace": "DISPATCH",
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
