"""The reference's ``tests/test_chaos.py``, run against the port's chaos worlds and runtime.

Every test of that file runs here with ``heat_tpu`` read as
``heat_tpu_torch`` (its imports, module paths and the ``ht`` fixture), on
the CPU, and the reference's launcher read as the port's
(``scripts/multiprocess_dryrun.py`` as ``heat_tpu_torch/chaos/world.py``,
``scripts/postmortem.py`` as ``heat_tpu_torch/analysis/postmortem.py``), so
the port is held to the reference's own cases.  The reference's marks stay:
the whole file is ``slow``.  ``PORT_READINGS`` reads the reference's launch
shape as the port's (a world's shape is its rank count, with no devices per
process; the launcher's last line is ``world.FAIL_MARKER``; a DNDarray's
local tensor is ``larray``; the checkpoint victim asks for the CPU, since
the port's entry points default to the card).  ``NOT_PORTED`` names each test left out and
why.
"""

import pathlib
import re

import pytest

import heat_tpu_torch as _htt

_REF = pathlib.Path(__file__).with_name("test_chaos.py")
_SRC = re.sub(r"\bheat_tpu\b(?!_torch)", "heat_tpu_torch", _REF.read_text())
PORT_READINGS = (
    ('os.path.join(REPO, "scripts", "multiprocess_dryrun.py")', 'os.path.join(REPO, "heat_tpu_torch", "chaos", "world.py")'),
    ('os.path.join(REPO, "scripts", "postmortem.py")', 'os.path.join(REPO, "heat_tpu_torch", "analysis", "postmortem.py")'),
    ("            devs_per_proc=4,\n", ""),
    ('"MULTIPROCESS DRYRUN: FAIL"', "mpd.FAIL_MARKER"),
    ("comm.Wait(x._jarray)", "comm.Wait(x.larray)"),
    ("import heat_tpu_torch as ht\n\nn = 64", "import heat_tpu_torch as ht\nht.use_device('cpu')\n\nn = 64"),
)
for _old, _new in PORT_READINGS:
    assert _old in _SRC, _old
    _SRC = _SRC.replace(_old, _new)
exec(compile(_SRC, f"{_REF.name}[heat_tpu_torch]", "exec"), globals())

REASONS = {
    "JAX": "drives the JAX package's own surface (a device mesh of 8 CPU devices, `NamedSharding`, staged bucket programs), which the port does not have",
    "MEMLEDGER": "the port's memory ledger registers buffers at the bucketed sync and at checkpoint loads, not at every factory and resplit tile (ROADMAP, the runtime plane), so no `zeros` provenance or `comm.resplit_tiled` request reaches the ring",
}
NOT_PORTED = {
    "TestInjectedOOM::test_injected_oom_mid_resplit_yields_oom_verdict_after_sigkill": "MEMLEDGER",
    "TestOverlappedSyncHang::test_hang_on_one_bucket_names_straggler_at_that_bucket": "JAX",
}
for _test, _why in NOT_PORTED.items():
    _cls, _, _fn = _test.partition("::")
    assert _why in REASONS and hasattr(globals()[_cls], _fn), _test
    delattr(globals()[_cls], _fn)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    """This process and the chaos worlds it launches run the port on the CPU."""
    monkeypatch.setenv("MPDRYRUN_DEVICE", "cpu")
    prev = _htt.get_device()
    _htt.use_device("cpu")
    yield
    _htt.use_device(prev)


@pytest.fixture(name="ht")
def _port_ht():
    return _htt
