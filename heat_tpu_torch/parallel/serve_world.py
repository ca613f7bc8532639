"""A supervised serving world: the serving tier's path through the system.

:func:`serve_supervised` runs a job stream through ``n_ranks`` worker
processes under a :class:`~heat_tpu_torch.parallel.supervisor.Supervisor`:
every rank runs the identical :class:`~heat_tpu_torch.parallel.scheduler.Scheduler`
over the identical submissions with :func:`~heat_tpu_torch.parallel.serving.make_executor`
on its communicator (gloo: several ranks may share one card, where NCCL
refuses), and rank 0 journals.  A worker is started with ``subprocess``
(``python -m heat_tpu_torch.parallel.serve_world``), never forked, so no
child inherits an initialised CUDA context.  ``kill`` arms
``HEAT_TPU_FAULTS`` on one rank of the first generation (``sched.dispatch``
or ``proc.exit`` with ``exit=N``): that rank SIGKILLs itself at its N-th
firing, the supervisor tears the world down and relaunches it with
``HEAT_TPU_RESTART_EPOCH`` raised, and the new generation's ranks
``recover()`` the unfinished jobs from the journal, then drain the queue.
:func:`serve_local` runs the same stream at world size 1 in this process,
the reference the supervised world's digests are held to, and
:func:`check_served` checks the contract: every offered job shed with its
reason, or accepted and then DONE or FAILED with a reason; no job DONE in
one generation dispatched again in a later one; each digest within
``rtol`` of world size 1's.  As in the reference's serve scenario
(``scripts/multiprocess_dryrun.py``, ``serve_worker``), the queue holds
nine tenths of the stream, so the last tenth is shed at submit, and
every job has priority ``i % 3`` and a retry budget of one.

Run as a module it is one worker rank (the arguments are
:func:`serve_supervised`'s own); it writes ``rank<r>.epoch<e>.json`` with
its scheduler report and the KMeans kernels' launches into ``workdir``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

__all__ = ["job_stream", "queue_bound", "serve_supervised", "serve_local", "check_served", "stream_metrics"]

DEADLINE_S = 300.0  # every job's budget: far past its service time, a backstop for a wedged world
TENANTS = ("alpha", "beta", "gamma")
QUEUE_SHARE = 0.9  # the queue bound over the stream's length: the reference's 18 of 20, the rest shed
MAX_BATCH = 4
RESTART_BUDGET = 1


def job_stream(n_jobs: int, kmeans_n: int = 64, matmul_n: int = 16, solve_n: int = 12, features: int = 8,
               batch: int = 4) -> List[dict]:
    """A deterministic stream of ``n_jobs`` jobs of the four kinds from the
    three ``TENANTS``, round robin, at the given sizes (kmeans: ``kmeans_n``
    two-blob points, k = 2)."""
    kinds = [("kmeans", {"n": kmeans_n, "k": 2}), ("matmul", {"n": matmul_n}), ("solve", {"n": solve_n}),
             ("nn_forward", {"features": features, "batch": batch})]
    out = []
    for i in range(n_jobs):
        kind, payload = kinds[i % len(kinds)]
        out.append({"id": f"job{i:03d}", "kind": kind, "tenant": TENANTS[i % len(TENANTS)], "priority": i % 3,
                    "retry_budget": 1, "payload": dict(payload, seed=i)})
    return out


def _job(spec: dict):
    from .scheduler import Job

    return Job(spec["id"], spec["kind"], tenant=spec["tenant"], priority=int(spec["priority"]),
               deadline_s=DEADLINE_S, retry_budget=int(spec["retry_budget"]), payload=dict(spec["payload"]))


def queue_bound(n_jobs: int) -> int:
    """The scheduler's ``max_queue`` for a stream of ``n_jobs``."""
    return int(n_jobs * QUEUE_SHARE)


def serve_local(jobs: List[dict], device: str = "gpu") -> Dict[str, float]:
    """Each job's digest at world size 1 in this process, by job id."""
    import heat_tpu_torch as ht

    from . import serving

    prev = ht.get_device()
    ht.use_device(device)
    try:
        execute = serving.make_executor()
        return {spec["id"]: float(execute([_job(spec)])[0]["digest"]) for spec in jobs}
    finally:
        ht.use_device(prev)


def serve_supervised(jobs: List[dict], n_ranks: int, workdir: str, device: str = "gpu",
                     kill: Optional[dict] = None, heartbeat_timeout: float = 120.0,
                     generation_deadline: Optional[float] = None,
                     flightrec_dir: Optional[str] = None, telemetry_dir: Optional[str] = None) -> dict:
    """Serve ``jobs`` on ``n_ranks`` supervised worker processes.

    ``kill`` = ``{"rank": r, "site": "sched.dispatch" or "proc.exit",
    "at": N}`` kills rank r of the first generation at its N-th firing of
    the site.  ``flightrec_dir`` and ``telemetry_dir`` arm each rank's
    flight ring and telemetry export there (``HEAT_TPU_FLIGHTREC_DIR``,
    ``HEAT_TPU_TELEMETRY_DIR``, the rank's files by its rank).  Returns
    ``{"supervisor": SupervisorResult.report(),
    "journal": path, "workers": [each surviving worker's output],
    "seconds": wall time}``."""
    from .supervisor import Supervisor

    os.makedirs(workdir, exist_ok=True)
    spec_path = os.path.join(workdir, "jobs.json")
    with open(spec_path, "w") as fh:
        json.dump(jobs, fh)
    journal = os.path.join(workdir, "journal.jsonl")
    hb_dir = os.path.join(workdir, "heartbeats")
    if os.path.exists(journal):  # a fresh stream: no earlier run's records
        os.remove(journal)
    logs = []

    def spawn(rank: int, epoch: int, port: int) -> subprocess.Popen:
        env = dict(os.environ, HEAT_TPU_RESTART_EPOCH=str(epoch), HEAT_TPU_FLIGHTREC_RANK=str(rank),
                   HEAT_TPU_TELEMETRY_RANK=str(rank))
        env.pop("HEAT_TPU_FAULTS", None)
        if flightrec_dir:
            env["HEAT_TPU_FLIGHTREC_DIR"] = flightrec_dir
        if telemetry_dir:
            env.update(HEAT_TPU_TELEMETRY="1", HEAT_TPU_TELEMETRY_DIR=telemetry_dir)
        if kill is not None and epoch == 0 and rank == int(kill["rank"]):
            env["HEAT_TPU_FAULTS"] = f"{kill['site']}:exit={int(kill['at'])}"
        log = open(os.path.join(workdir, f"rank{rank}.epoch{epoch}.log"), "w")
        logs.append(log)
        cmd = [sys.executable, "-m", "heat_tpu_torch.parallel.serve_world", "--rank", str(rank), "--world",
               str(n_ranks), "--port", str(port), "--workdir", workdir, "--device", device]
        return subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

    t0 = time.perf_counter()
    sup = Supervisor(spawn, n_ranks, heartbeat_dir=hb_dir, heartbeat_timeout=heartbeat_timeout,
                     restart_budget=RESTART_BUDGET, generation_deadline=generation_deadline, poll_interval=0.2,
                     grace=2.0, job_journal=journal)
    try:
        result = sup.run()
    finally:
        for log in logs:
            log.close()
    seconds = time.perf_counter() - t0
    workers = []
    for name in sorted(os.listdir(workdir)):
        if name.startswith("rank") and name.endswith(".json") and ".epoch" in name:
            with open(os.path.join(workdir, name)) as fh:
                workers.append(json.load(fh))
    return {"supervisor": result.report(), "journal": journal, "workers": workers, "seconds": seconds}


def check_served(served: dict, jobs: List[dict], local: Dict[str, float], rtol: float) -> dict:
    """The serving contract over a :func:`serve_supervised` run; raises
    ``AssertionError`` naming what broke, else returns what it checked:
    the replayed summary, the largest digest error against ``local`` (the
    DONE jobs' digests at world size 1), and the jobs DONE in each
    generation."""
    from . import scheduler

    replay = scheduler.replay_journal(served["journal"])
    summary = scheduler.jobs_summary(replay)
    views = replay["jobs"]
    assert served["supervisor"]["ok"], f"the supervised world did not finish: {served['supervisor']}"
    assert set(views) == {j["id"] for j in jobs}, "the journal does not hold every submitted job"
    for jid, v in views.items():
        assert v.get("state") in (scheduler.DONE, scheduler.FAILED, scheduler.SHED), f"job {jid} ended {v.get('state')}"
        if v.get("state") != scheduler.DONE:
            assert v.get("reason"), f"job {jid} {v['state']} without a reason"
    shed = sorted(jid for jid, v in views.items() if v["state"] == scheduler.SHED)
    assert shed == sorted(j["id"] for j in jobs[queue_bound(len(jobs)):]), \
        f"the jobs shed are {shed}, not those past the queue bound {queue_bound(len(jobs))}"
    done_in: Dict[int, set] = {}
    dispatched_in: Dict[int, set] = {}
    for rec in replay["records"]:
        e = int(rec.get("epoch", 0) or 0)
        if rec.get("type") == scheduler.DONE:
            done_in.setdefault(e, set()).add(rec["id"])
        elif rec.get("type") == scheduler.DISPATCHED:
            dispatched_in.setdefault(e, set()).add(rec["id"])
    for e, done in done_in.items():
        later = set().union(*(ids for g, ids in dispatched_in.items() if g > e)) if dispatched_in else set()
        again = done & later
        assert not again, f"jobs DONE in generation {e} ran again later: {sorted(again)}"
    worst = 0.0
    for jid, v in views.items():
        if v.get("state") != scheduler.DONE:
            continue
        got, want = float(v["result"]["digest"]), local[jid]
        err = abs(got - want) / max(abs(want), 1e-30)
        worst = max(worst, err)
        assert err <= rtol, f"job {jid}: digest {got} vs world size 1's {want} (rel {err:.3g} > {rtol})"
    return {"summary": summary, "digest_max_rel_err": worst,
            "done_by_generation": {str(e): len(ids) for e, ids in sorted(done_in.items())}}


def stream_metrics(served: dict, jobs: List[dict]) -> dict:
    """Jobs/s, p50 and p99 latency by kind (submit to finish, journal wall
    clock, a requeued job's downtime included), and the recovery seconds
    (the last record of the first generation to the first of the next)."""
    from . import scheduler

    replay = scheduler.replay_journal(served["journal"])
    kinds = {j["id"]: j["kind"] for j in jobs}
    lat: Dict[str, List[float]] = {}
    finishes, submits = [], []
    for jid, v in replay["jobs"].items():
        if v.get("state") == scheduler.DONE and isinstance(v.get("finish_t"), float):
            lat.setdefault(kinds[jid], []).append(v["finish_t"] - v["submit_t"])
            finishes.append(v["finish_t"])
            submits.append(v["submit_t"])

    def pct(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]

    recs = [r for r in replay["records"] if isinstance(r.get("t"), float)]
    last0 = max((r["t"] for r in recs if int(r.get("epoch", 0) or 0) == 0), default=None)
    first1 = min((r["t"] for r in recs if int(r.get("epoch", 0) or 0) >= 1), default=None)
    done = len(finishes)
    span = (max(finishes) - min(submits)) if finishes else 0.0
    return {"jobs_done": done, "jobs_per_s": done / span if span > 0 else None,
            "latency_s": {k: {"p50": pct(v, 0.5), "p99": pct(v, 0.99), "n": len(v)} for k, v in sorted(lat.items())},
            "recovery_s": (first1 - last0) if last0 is not None and first1 is not None else None}


def _worker(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of a supervised serving world")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--device", default="gpu")
    args = ap.parse_args(argv)

    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1)  # the supervisor's stack-dump request before a kill

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import bootstrap
    from heat_tpu_torch.ops import kmeans_kernels
    from heat_tpu_torch.parallel import scheduler, serving
    from heat_tpu_torch.utils import health

    ht.use_device(args.device)
    if args.device == "gpu":
        import torch

        torch.cuda.set_device(0)
    bootstrap.init_distributed(f"tcp://localhost:{args.port}", world_size=args.world, rank=args.rank,
                               backend="gloo")
    comm = ht.communication.get_comm()
    epoch = health.restart_epoch()
    journal_path = os.path.join(args.workdir, "journal.jsonl")
    with open(os.path.join(args.workdir, "jobs.json")) as fh:
        jobs = json.load(fh)
    beacon = health.Heartbeat(os.path.join(args.workdir, "heartbeats", f"rank{args.rank}.json"))
    beacon.beat(0)
    journal = scheduler.JobJournal(journal_path, epoch=epoch) if args.rank == 0 else None
    s = scheduler.Scheduler(serving.make_executor(comm), journal=journal, max_queue=queue_bound(len(jobs)),
                            max_batch=MAX_BATCH, batch_key=serving.batch_key)
    if epoch == 0:
        for spec in jobs:
            try:
                s.submit(_job(spec))
            except scheduler.JobRejected:  # shed at once, journaled with its reason; the stream goes on
                pass
        requeued = 0
    else:
        requeued = s.recover(journal_path, epoch=epoch)
    comm.Barrier()  # every rank has its queue before any dispatch
    t0 = time.perf_counter()
    report = s.run(beat=beacon.beat)
    comm.Barrier()
    out = {"rank": args.rank, "epoch": epoch, "requeued": requeued, "seconds": time.perf_counter() - t0,
           "report": report, "kmeans_launches": dict(kmeans_kernels.launch_counts)}
    with open(os.path.join(args.workdir, f"rank{args.rank}.epoch{epoch}.json"), "w") as fh:
        json.dump(out, fh, default=str)
    bootstrap.finalize_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(_worker())
