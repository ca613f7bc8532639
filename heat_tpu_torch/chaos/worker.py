"""Fast-tier chaos harness worker: one supervised rank, no torch.

The campaign's breadth tier.  A real subprocess, supervised by the real
``parallel/supervisor.py``, running the real journaled scheduler (and,
in fed mode, the real federation layer) with the real fault registry
armed through the production ``HEAT_TPU_FAULTS`` env plumbing — only the
*payload* is a stub.  Every registered fault site is deterministically
reached at the same layer the port's runtime fires it from (the executor
stands in for compute: it stages "collectives", mints and drains
transient artifacts through verified writes, checkpoints, and exposes
the per-step ``proc.exit`` window), so a schedule drawn from
``faults.catalog()`` injects against the same recovery machinery —
journals, replay, requeue, restart-with-resume, heartbeat staleness,
stack-dump teardown — that the full worlds of ``chaos/world.py`` exercise, at
~100× the throughput the CI campaign budget needs.

Invoked by ``chaos/engine.py`` as ``python worker.py <rank>`` with:

- ``CHAOS_DIR``       run directory (journals, rings, beacons, reports)
- ``CHAOS_WORKLOAD``  train | serve | fed
- ``CHAOS_JOBS``      job/step count
- ``HEAT_TPU_RESTART_EPOCH`` / ``HEAT_TPU_FAULTS``  the existing plumbing

Evidence written for the invariant oracles: the scheduler/federation
journals (replayed post-hoc), ``exec_rank<r>.log`` (one line per actual
execution — the exactly-once witness), ``trips_rank<r>.json`` (fired
sites — the injection witness), ``report_rank<r>_epoch<e>.json``
(counters + reconciliation), flight rings (post-mortem blame), and the
scratch dir itself (empty = transients drained).

Stdlib-only; every runtime module is spec-loaded by path.  The faults
module is registered in ``sys.modules`` under its canonical name so the
scheduler's ``_fire`` hook and the env arming see ONE registry.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.normpath(os.path.join(_HERE, ".."))  # the heat_tpu_torch package


def _load(name: str, relpath: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_PKG, relpath)
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# canonical name: the scheduler/federation _fire hooks resolve
# sys.modules["heat_tpu_torch.utils.faults"], and faults parses HEAT_TPU_FAULTS
# at import — one load, one armed registry
flt = _load("heat_tpu_torch.utils.faults", os.path.join("utils", "faults.py"))
frm = _load("heat_chaos_flightrec", os.path.join("utils", "flightrec.py"))
sched_mod = _load(
    "heat_federation_scheduler", os.path.join("parallel", "scheduler.py")
)


def _atomic_json(path: str, obj) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


class Harness:
    """Per-rank context: beacons, ring, scratch, evidence files."""

    def __init__(self, rank: int):
        self.rank = rank
        self.dir = os.environ["CHAOS_DIR"]
        self.workload = os.environ.get("CHAOS_WORKLOAD", "serve")
        self.n_jobs = int(os.environ.get("CHAOS_JOBS", "8"))
        self.epoch = int(os.environ.get("HEAT_TPU_RESTART_EPOCH", "0") or 0)
        self.scratch = os.path.join(self.dir, f"scratch_rank{rank}")
        self.ckpt_dir = os.path.join(self.dir, f"ckpt_rank{rank}")
        self.hb_path = os.path.join(self.dir, "hb", f"rank{rank}.json")
        os.makedirs(self.scratch, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(os.path.dirname(self.hb_path), exist_ok=True)
        self.ring = frm.FlightRecorder(
            os.path.join(self.dir, "fr", f"flight_rank{rank}.ring"),
            slots=256, rank=rank,
        )
        self.exec_log = open(
            os.path.join(self.dir, f"exec_rank{rank}.log"), "a"
        )
        self._seq = 0
        # a PREVIOUS generation's crash may have left transients behind:
        # sweeping them on startup is the recovery discipline the
        # mem-drained oracle checks (scratch must be empty at the end)
        for name in os.listdir(self.scratch):
            os.unlink(os.path.join(self.scratch, name))
        self.beat()

    # -- evidence ------------------------------------------------------ #
    def beat(self) -> None:
        last = self.ring.last_collective()
        self._seq = last[0] if last else 0
        _atomic_json(self.hb_path, {
            "t": time.time(),
            "seq": self._seq,
            "collective": "chaos",
            "mem_live": self.scratch_bytes(),
        })

    def scratch_bytes(self) -> int:
        total = 0
        for name in os.listdir(self.scratch):
            try:
                total += os.path.getsize(os.path.join(self.scratch, name))
            except OSError:
                pass
        return total

    def save_trips(self) -> None:
        path = os.path.join(self.dir, f"trips_rank{self.rank}.json")
        merged = {}
        try:
            with open(path) as fh:
                merged = json.load(fh)
        except (OSError, ValueError):
            pass
        for site, n in flt.trips().items():
            # per-generation counts accumulate: max within a generation,
            # summed across them via the epoch key
            merged[f"e{self.epoch}:{site}"] = n
        _atomic_json(path, merged)

    def note_exec(self, job_id: str) -> None:
        self.exec_log.write(f"{self.epoch} {job_id}\n")
        self.exec_log.flush()

    # -- the stub payload: every catalog site, at its own layer -------- #
    def run_artifact(self, job_id: str, payload: bytes) -> str:
        """A verified transient write: the io.write/io.fsync/corrupt
        surface.  Bit-rot injected after the checksum (corrupt mode) is
        detected by the read-back and healed by a rewrite — the io.py
        verification idiom, minus torch."""
        digest = hashlib.sha256(payload).hexdigest()[:16]
        path = os.path.join(self.scratch, f"{job_id}.tmp")
        for _ in range(3):
            def write_once():
                with open(path, "wb") as fh:
                    fh.write(payload)
                flt.fire("io.write", path=path)
                flt.fire("io.fsync", path=path)

            flt.call_with_retries(
                write_once, "io.write", retries=4,
                base_delay=0.005, max_delay=0.02,
            )
            with open(path, "rb") as fh:
                back = fh.read()
            if hashlib.sha256(back).hexdigest()[:16] == digest:
                return digest
        raise RuntimeError(f"artifact {job_id} failed verification 3x")

    def checkpoint(self, step: int) -> None:
        """tmp+rename checkpoint write (the durable-write surface the
        kill-mid-save scenario exercises): a crash between write and
        rename leaves the previous checkpoint intact."""
        path = os.path.join(self.ckpt_dir, "LATEST")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"step": step, "epoch": self.epoch}, fh)
        flt.fire("io.write", path=tmp)
        flt.fire("io.fsync", path=tmp)
        os.replace(tmp, path)

    def resume_probe(self) -> int:
        """The io.read surface: every generation reads the durable state
        it would resume from (step 0 when none exists yet)."""
        path = os.path.join(self.ckpt_dir, "LATEST")
        def read_once():
            flt.fire("io.read", path=path if os.path.exists(path) else None)
            if os.path.exists(path):
                with open(path) as fh:
                    try:
                        return int(json.load(fh).get("step", 0))
                    except ValueError:
                        return 0  # corrupt-mode bit flip: fall back
            return 0

        return flt.call_with_retries(
            read_once, "io.read", retries=4, base_delay=0.005, max_delay=0.02,
        )

    def make_executor(self, is_train: bool):
        def executor(batch):
            results = []
            for job in batch:
                self.note_exec(job.job_id)
                flt.fire("comm.collective")
                self.ring.record_collective(f"chaos.{job.kind}", 1024)
                flt.fire("mem.alloc")
                payload = json.dumps(
                    {"id": job.job_id, **job.payload}, sort_keys=True
                ).encode()
                digest = self.run_artifact(job.job_id, payload)
                flt.fire("comm.host_fetch")
                os.unlink(os.path.join(self.scratch, f"{job.job_id}.tmp"))
                if is_train and (int(job.payload.get("i", 0)) + 1) % 3 == 0:
                    self.checkpoint(int(job.payload.get("i", 0)) + 1)
                flt.fire("proc.exit")
                self.beat()
                self.save_trips()
                results.append(digest)
            return results
        return executor

    def close(self, extra: dict) -> None:
        self.save_trips()
        self.beat()
        self.ring.record("shutdown")
        self.ring.close()
        self.exec_log.close()
        _atomic_json(
            os.path.join(self.dir, f"report_rank{self.rank}_epoch{self.epoch}.json"),
            extra,
        )
        print(f"CHAOS-TRIPS {json.dumps(flt.trips(), sort_keys=True)}", flush=True)


# ---------------------------------------------------------------------- #
# workloads
# ---------------------------------------------------------------------- #
def _submit_missing(h: Harness, s, journal_path: str, is_train: bool) -> None:
    """Submit every planned job the journal has never seen; recovery owns
    the rest (requeue of unfinished, exactly-once close-out of DONE).

    Every generation also submits one epoch-scoped PROBE job: a restarted
    rank whose planned jobs all finished before the crash would otherwise
    run an empty generation in which the executor-layer fault sites
    (comm/mem/io/proc) never fire — and a benign fault the campaign
    re-pinned to the post-restart generation would be armed against a
    site with no traffic, failing the blame oracle's armed-but-never-
    fired check for a schedule that DID test the runtime."""
    known = {}
    try:
        known = sched_mod.replay_journal(journal_path)["jobs"]
    except (OSError, ValueError):
        pass
    kinds = ("step",) if is_train else ("matmul", "resplit", "digest")
    probe_id = f"r{h.rank}e{h.epoch}probe"
    if probe_id not in known or known[probe_id].get("state") == sched_mod.SHED:
        probe = sched_mod.Job(
            job_id=probe_id,
            kind=kinds[0],
            tenant="default",
            retry_budget=4,
            payload={"i": h.n_jobs, "rank": h.rank},
        )
        flt.call_with_retries(
            lambda: s.submit(probe), "chaos.submit", retries=4,
            base_delay=0.005, max_delay=0.02,
        )
    for i in range(h.n_jobs):
        jid = f"r{h.rank}j{i:03d}"
        if jid in known and known[jid].get("state") != sched_mod.SHED:
            continue
        job = sched_mod.Job(
            job_id=jid,
            kind=kinds[i % len(kinds)],
            tenant="default" if is_train else f"tenant{i % 2}",
            priority=0 if is_train else i % 2,
            retry_budget=4,
            payload={"i": i, "rank": h.rank},
            batch_key=None if is_train else kinds[i % len(kinds)],
        )
        flt.call_with_retries(
            lambda j=job: s.submit(j), "chaos.submit", retries=4,
            base_delay=0.005, max_delay=0.02,
        )
    if not is_train:
        # one deliberately infeasible job: the shed path must stay
        # journaled and accounted under chaos too (offered = accepted+shed)
        jid = f"r{h.rank}inf"
        if jid not in known:
            try:
                _retrying(
                    lambda: s.submit(sched_mod.Job(
                        job_id=jid, kind="infeasible", deadline_s=0.5,
                        payload={"rank": h.rank},
                    )),
                    "chaos.submit",
                )
            except sched_mod.JobRejected:
                pass


def _retrying(fn, site: str):
    """Bounded retry for the harness's own journal-touching calls: the
    restarted generation's journal REOPEN (and recovery's requeue appends)
    fire ``sched.journal.write`` outside the scheduler's protected dispatch
    loop, and every one of those call sites is journal-first/idempotent —
    a benign injected fault there must heal, not kill the generation."""
    return flt.call_with_retries(
        fn, site, retries=4, base_delay=0.005, max_delay=0.02,
    )


def run_sched_workload(h: Harness) -> int:
    is_train = h.workload == "train"
    h.resume_probe()
    journal_path = os.path.join(h.dir, f"journal_rank{h.rank}.jsonl")
    existed = os.path.exists(journal_path)
    journal = _retrying(
        lambda: sched_mod.JobJournal(journal_path, epoch=h.epoch),
        "chaos.journal.open",
    )
    s = sched_mod.Scheduler(
        h.make_executor(is_train),
        max_batch=1 if is_train else 3,
        journal=journal,
        min_exec_estimate={"infeasible": 1.0},
        retry_base_delay=0.005,
        retry_max_delay=0.02,
    )
    if existed:
        _retrying(lambda: s.recover(journal_path, epoch=h.epoch),
                  "chaos.recover")
    _submit_missing(h, s, journal_path, is_train)
    report = s.run(beat=h.beat)
    summary = sched_mod.jobs_summary(sched_mod.replay_journal(journal_path))
    print(sched_mod.attestation_line(summary), flush=True)
    h.close({
        "workload": h.workload,
        "report": report,
        "summary": summary,
        "reconciled": s.counters_reconcile(),
        "counters": sched_mod.counters(),
        "scratch_bytes": h.scratch_bytes(),
        "trips": flt.trips(),
    })
    marker = "CHAOS-TRAIN-OK" if is_train else "CHAOS-SERVE-OK"
    print(f"{marker} rank={h.rank} epoch={h.epoch} done={summary['done']}",
          flush=True)
    return 0 if summary["lost"] == 0 else 3


def run_fed_workload(h: Harness) -> int:
    fed_mod = _load(
        "heat_chaos_federation",
        os.path.join("parallel", "federation.py"),
    )
    h.resume_probe()
    fed_path = os.path.join(h.dir, "fed.jsonl")
    existed = os.path.exists(fed_path)
    fed = _retrying(
        lambda: fed_mod.Federation(fed_path, stale_after=300.0),
        "chaos.journal.open",
    )
    worlds = {}
    for k in (0, 1):
        wname = f"w{k}"
        wj_path = os.path.join(h.dir, f"fed_{wname}.jsonl")
        ws = sched_mod.Scheduler(
            h.make_executor(False),
            max_batch=3,
            journal=_retrying(
                lambda p=wj_path: sched_mod.JobJournal(p, epoch=h.epoch),
                "chaos.journal.open",
            ),
            retry_base_delay=0.005,
            retry_max_delay=0.02,
        )
        worlds[wname] = ws
        _retrying(
            lambda n=wname, p=wj_path, s=ws: fed.add_world(
                n, n_ranks=1, journal_path=p,
                submit=lambda job, _s=s: _s.submit(job),
            ),
            "chaos.add_world",
        )
    if existed:
        # the federator restarted: rebuild from the federation journal,
        # then fold in what the worlds finished before the crash (their
        # journals survived even though their schedulers are fresh)
        _retrying(lambda: fed.recover(fed_path, epoch=h.epoch),
                  "chaos.recover")
        for wname in worlds:
            _retrying(lambda n=wname: fed.reconcile_world_journal(n),
                      "chaos.reconcile")
    known = {}
    try:
        known = fed_mod.replay_federation(fed_path)["jobs"] if existed else {}
    except (OSError, ValueError):
        pass
    # epoch-scoped probe (see _submit_missing): a restarted federation
    # whose planned jobs all finished pre-crash still executes one job,
    # so every executor-layer site has gen-1 traffic for re-pinned
    # benign faults to hit
    probe_id = f"fe{h.epoch}probe"
    if probe_id not in known or known[probe_id].get("state") in (None, fed_mod.SHED):
        probe = sched_mod.Job(
            job_id=probe_id, kind="digest", tenant="tenant0",
            retry_budget=4, payload={"i": h.n_jobs, "rank": h.rank},
        )
        flt.call_with_retries(
            lambda: fed.submit(probe), "chaos.submit", retries=4,
            base_delay=0.005, max_delay=0.02,
        )
    for i in range(h.n_jobs):
        jid = f"fj{i:03d}"
        if jid in known and known[jid].get("state") not in (None, fed_mod.SHED):
            continue
        job = sched_mod.Job(
            job_id=jid, kind=("matmul", "digest")[i % 2],
            tenant=f"tenant{i % 2}", priority=i % 2, retry_budget=4,
            payload={"i": i, "rank": h.rank},
        )
        flt.call_with_retries(
            lambda j=job: fed.submit(j), "chaos.submit", retries=4,
            base_delay=0.005, max_delay=0.02,
        )
    for _ in range(20):
        _retrying(fed.assign, "chaos.assign")
        for wname, ws in worlds.items():
            ws.run(beat=h.beat)
            _retrying(lambda n=wname: fed.reconcile_world_journal(n),
                      "chaos.reconcile")
        rep = fed.health_report()
        if rep["queue_depth"] == 0 and all(
            not w.assigned for w in fed.worlds.values()
        ):
            break
    line = fed.attestation()
    print(line, flush=True)
    summary = fed_mod.fed_summary(fed_mod.replay_federation(fed_path))
    h.close({
        "workload": "fed",
        "summary": summary,
        "counters": {**sched_mod.counters(), **fed_mod.counters()},
        "scratch_bytes": h.scratch_bytes(),
        "trips": flt.trips(),
    })
    print(f"CHAOS-FED-OK rank={h.rank} epoch={h.epoch} done={summary['done']}",
          flush=True)
    return 0 if summary["lost"] == 0 else 3


def main(argv) -> int:
    rank = int(argv[1]) if len(argv) > 1 else 0
    h = Harness(rank)
    print(
        f"CHAOS-WORKER rank={rank} epoch={h.epoch} workload={h.workload} "
        f"faults={os.environ.get('HEAT_TPU_FAULTS', '')!r}",
        flush=True,
    )
    # the bootstrap surface: dist.init fires before any work, with the
    # same bounded retry the real init path gets
    flt.call_with_retries(
        lambda: flt.fire("dist.init"), "dist.init", retries=4,
        base_delay=0.005, max_delay=0.02,
    )
    if h.workload == "fed":
        return run_fed_workload(h)
    return run_sched_workload(h)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
