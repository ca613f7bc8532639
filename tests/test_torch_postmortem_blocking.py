"""The post-mortem under the port's blocking collectives.

The port's collectives block until every rank joins, so a rank wedged at
the staging point holds its peers at its own seq: every ring ends at the
same seq.  ``Communication._account_bytes`` marks each collective
``enter`` once it is past staging (the fault site, the deadline guard),
and the analyzers read those marks: the rank that stamped the last seq
without going into its transport is the straggler, lag 0, in
``analysis/postmortem.py``'s verdict and in ``analysis/timeline.py``'s
critical path.  Rings with no marks at all (the reference's, whose
collectives stage asynchronously) read as before.
"""

import pytest

from heat_tpu_torch.analysis import postmortem, timeline
from heat_tpu_torch.core.communication import Communication
from heat_tpu_torch.utils import faults, flightrec

N_SEQ = 5


def _write_rings(directory, entered_through):
    """One ring a rank, each ``N_SEQ`` stamped Alltoalls; rank r's
    ``enter`` marks run through seq ``entered_through[r]`` (None: none)."""
    for rank, last in enumerate(entered_through):
        rec = flightrec.FlightRecorder(str(directory / f"flight_rank{rank}.ring"), rank=rank)
        for seq in range(1, N_SEQ + 1):
            assert rec.record_collective("Alltoall", 64, None, 0, 1) == seq
            if last is not None and seq <= last:
                rec.record_enter(seq)
        rec.close()
    return str(directory)


def _critical_line(directory) -> str:
    lines = timeline.critical_path(timeline.assemble([directory]))["lines"]
    return next(line for line in lines if line.startswith("CRITICAL-PATH kind=collective"))


@pytest.mark.parametrize("entered_through, straggler", [
    ((N_SEQ, N_SEQ - 1), 1),
    ((N_SEQ - 1, N_SEQ, N_SEQ), 0),
    ((N_SEQ, N_SEQ - 1, N_SEQ), 1),
], ids=["2-ranks-rank1", "3-ranks-rank0", "3-ranks-rank1"])
def test_the_rank_short_of_the_transport_is_the_straggler(tmp_path, entered_through, straggler):
    directory = _write_rings(tmp_path, entered_through)
    v = postmortem.analyze_dir(directory, expected_ranks=list(range(len(entered_through))))
    waiting = [r for r in range(len(entered_through)) if r != straggler]
    assert v["verdict"] == "straggler", v
    assert v["straggler"]["rank"] == straggler and v["straggler"]["seq"] == N_SEQ and v["straggler"]["lag"] == 0
    assert v["straggler"]["op"] == "Alltoall" and v["straggler"]["waiting"] == waiting
    assert postmortem.summary_line(v, epoch=0).startswith(
        f"POSTMORTEM epoch=0 verdict=straggler rank={straggler} seq={N_SEQ} op=Alltoall lag=0")
    assert _critical_line(directory).startswith(f"CRITICAL-PATH kind=collective rank={straggler} op=Alltoall seq={N_SEQ}")


@pytest.mark.parametrize("entered_through", [(N_SEQ, N_SEQ), (None, None)], ids=["all-inside", "no-marks"])
def test_level_streams_without_a_short_rank_stay_inconclusive(tmp_path, entered_through):
    """Every rank in the transport (a global stall), or rings without marks:
    nothing names a rank, as before the marks."""
    v = postmortem.analyze_dir(_write_rings(tmp_path, entered_through), expected_ranks=[0, 1])
    assert v["verdict"] == "inconclusive" and v["straggler"] is None, v


def test_a_rank_behind_outranks_the_marks(tmp_path):
    """A stream that stops short is the straggler whatever the marks say."""
    directory = _write_rings(tmp_path, (N_SEQ, N_SEQ))
    rec = flightrec.FlightRecorder(str(tmp_path / "flight_rank2.ring"), rank=2)
    for seq in range(1, N_SEQ):
        rec.record_collective("Alltoall", 64, None, 0, 1)
        rec.record_enter(seq)
    rec.close()
    v = postmortem.analyze_dir(directory, expected_ranks=[0, 1, 2])
    assert v["verdict"] == "straggler" and v["straggler"]["rank"] == 2 and v["straggler"]["lag"] == 1, v
    assert "waiting" not in v["straggler"]


def test_account_marks_enter_past_staging_only(tmp_path):
    """The choke point stamps, fires the fault site, then marks ``enter``:
    a collective refused at staging leaves its stamp and no mark."""
    path = flightrec.enable(str(tmp_path), rank=0)
    try:
        comm = Communication()
        comm._account_bytes("Alltoall", 64)
        with faults.inject("comm.collective", fail=1), pytest.raises(faults.InjectedFault):
            comm._account_bytes("Alltoall", 64)
        comm._account_bytes("Allreduce", 32)
    finally:
        flightrec.disable()
    recs = [(r["k"], r["seq"]) for r in flightrec.read_ring(path)["records"] if r["k"] in ("coll", "enter")]
    assert recs == [("coll", 1), ("enter", 1), ("coll", 2), ("coll", 3), ("enter", 3)]
