"""The supervised serving world on the CPU: 2 gloo ranks, one killed.

One module-scoped run (:func:`heat_tpu_torch.parallel.serve_world.serve_supervised`)
offers a stream of 16 jobs from 3 tenants to a queue of 14, so the last
two are shed at submit with their reason; rank 1 SIGKILLs itself at its
second ``sched.dispatch``, the supervisor relaunches the world, and the new
generation recovers from rank 0's journal.  Every accepted job ends DONE
(or FAILED with a reason), no job DONE before the kill runs again, every
digest agrees with the world-size-1 run within 1e-5 relative, and the
journal reads in the reference's replay.  Each rank's flight ring and
telemetry file, armed by environment, show the collectives stamped and
accounted in lockstep at world size 2, read by the reference's tools.
"""

import importlib.util
import os

import pytest

from heat_tpu.parallel import scheduler as ref_sched

from heat_tpu_torch.parallel import serve_world as sw
from heat_tpu_torch.utils import flightrec as port_flightrec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_RTOL = 1e-5
JOBS = sw.job_stream(16)
ACCEPTED = sw.queue_bound(len(JOBS))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve")
    out = sw.serve_supervised(JOBS, 2, str(work / "world"), device="cpu",
                              kill={"rank": 1, "site": "sched.dispatch", "at": 2},
                              flightrec_dir=str(work / "rings"), telemetry_dir=str(work / "tel"))
    out["local"] = sw.serve_local(JOBS, device="cpu")
    out["dirs"] = work
    return out


def test_the_world_restarts_once_after_the_kill(served):
    sup = served["supervisor"]
    assert sup["ok"] and sup["restarts"] == 1 and sup["generations"] == 2
    assert "rank 1 died with exit code -9" in sup["failures"][0]
    assert sup["jobs"]["lost"] == 0 and sup["jobs"]["accepted"] == ACCEPTED


def test_every_job_ends_and_digests_match_world_one(served):
    got = sw.check_served(served, JOBS, served["local"], SERVE_RTOL)
    assert got["digest_max_rel_err"] <= SERVE_RTOL
    assert got["summary"]["done"] + got["summary"]["failed"] == ACCEPTED
    assert got["done_by_generation"]["1"] > 0  # the relaunched world served the requeued jobs


def test_the_jobs_past_the_queue_bound_are_shed_with_their_reason(served):
    assert 0 < ACCEPTED < len(JOBS)
    views = ref_sched.replay_journal(served["journal"])["jobs"]
    shed = {jid: v["reason"] for jid, v in views.items() if v["state"] == ref_sched.SHED}
    assert shed == {j["id"]: ref_sched.QUEUE_FULL for j in JOBS[ACCEPTED:]}
    assert served["supervisor"]["jobs"]["shed"] == len(JOBS) - ACCEPTED
    assert all(j["priority"] == i % 3 and j["retry_budget"] == 1 for i, j in enumerate(JOBS))


def test_the_requeued_jobs_are_those_unfinished_at_the_kill(served):
    workers = {(w["rank"], w["epoch"]): w for w in served["workers"]}
    assert set(workers) == {(0, 1), (1, 1)}  # the first generation was killed: no output
    summary = served["supervisor"]["jobs"]
    assert workers[0, 1]["requeued"] == workers[1, 1]["requeued"] == summary["requeued"] > 0


def test_the_journal_replays_in_the_reference(served):
    ref = ref_sched.jobs_summary(ref_sched.replay_journal(served["journal"]))
    assert ref == served["supervisor"]["jobs"]


def test_metrics_of_the_stream(served):
    m = sw.stream_metrics(served, JOBS)
    assert m["jobs_done"] == served["supervisor"]["jobs"]["done"]
    assert set(m["latency_s"]) == {"kmeans", "matmul", "solve", "nn_forward"}
    assert m["recovery_s"] is not None and m["recovery_s"] > 0


def test_collectives_are_stamped_in_lockstep_and_read_by_the_reference(served):
    rings = {}
    for r in (0, 1):
        ring = port_flightrec.read_ring(str(served["dirs"] / "rings" / f"flight_rank{r}.ring"))
        rings[r] = [(c["seq"], c["op"], c["wire"]) for c in ring["records"] if c["k"] == "coll"]
    assert rings[0] and rings[0] == rings[1]
    assert [s for s, _, _ in rings[0]] == list(range(1, len(rings[0]) + 1))
    pm = _script("postmortem")
    ref_rings = pm.load_rings(str(served["dirs"] / "rings"))
    assert sorted(ref_rings) == [0, 1]
    assert [(c["seq"], c["op"], c["wire"]) for c in ref_rings[1]["records"] if c["k"] == "coll"] == rings[1]


def test_telemetry_accounts_the_collectives_on_both_ranks(served):
    report = _script("telemetry_report")
    paths = [str(served["dirs"] / "tel" / f"rank{r}.jsonl") for r in (0, 1)]
    merged = report.merge_files(paths)
    calls = {k: v for k, v in merged["counters"].items() if k.startswith("comm.") and k.endswith(".calls")}
    assert calls and all(v > 0 for v in calls.values())
