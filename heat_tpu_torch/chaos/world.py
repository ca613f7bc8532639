"""Supervised worlds of the port for the chaos scenarios.

    python heat_tpu_torch/chaos/world.py          (the launcher: MPDRYRUN_* environment)
    python heat_tpu_torch/chaos/world.py RANK     (one worker; internal)

The launcher runs ``MPDRYRUN_NPROC`` worker processes of the port under a
:class:`~heat_tpu_torch.parallel.supervisor.Supervisor` (heartbeat
staleness, stack-dump teardown, restart budget, resume epochs, the ring
post-mortem at teardown), then prints the whole run's attestation: each
rank's log, the merged telemetry report, the supervisor's line, the
journal's job accounting, the post-mortem verdicts, and the clock-aligned
timeline with its critical path and Chrome-trace export.  It ends with
``PASS_MARKER`` or ``FAIL_MARKER`` and exits 0 iff every worker reached its
marker in the final generation.  It never imports torch: the supervisor,
telemetry, scheduler, federation, monitor and the analyzers are loaded
standalone, by path.

The workers run ``heat_tpu_torch`` over gloo, all on the one card (NCCL
refuses two ranks on one card), or on the CPU with ``MPDRYRUN_DEVICE=cpu``.
``MPDRYRUN_MODE`` picks the world:

- ``train``: DASO steps with ``checkpoint_every``; ``proc.exit:exit=N``
  armed on one rank SIGKILLs it, the supervisor restarts the world, and
  every rank resumes from the newest verified checkpoint
  (``RESUMED epoch=K step=N``) and trains to the target (``TRAIN-OK``).
- ``serve``: the serving stream of :mod:`heat_tpu_torch.parallel.serve_world`
  (its job kinds, sizes and queue bound) through every rank's scheduler,
  rank 0 journaling; ``sched.dispatch:exit=N`` on one rank kills it
  mid-queue, and the next generation requeues the unfinished jobs from the
  journal (``SCHED-RECOVERED``).
- ``postmortem``: a loop of ``resplit_`` flips, one accounted collective
  each, and at ``MPDRYRUN_CHAOS_AT`` either a ``comm.collective`` hang on
  ``MPDRYRUN_HANG_RANK`` (``PM-HANG expect_seq=N``) or one extra collective
  of another shape on ``MPDRYRUN_DESYNC_RANK`` (``PM-DESYNC expect_seq=N``);
  then every rank parks or waits in a transport, and heartbeat staleness
  must turn the wedge into a teardown and a verdict.  The flips block until
  every rank joins, so a wedged rank holds its peers at its own seq; the
  rings' ``enter`` marks tell the post-mortem which rank never went into
  the transport the others wait in.
- ``fed``: two one-rank worlds behind the federation's HTTP ingress on
  localhost; world ``w1`` is killed mid-queue with no restart budget, the
  federation quarantines it, steals its unfinished jobs, grows ``w0`` and
  serves them, and the federation journal attests ``FED worlds=2 lost=0``.

:func:`launch` runs the launcher as a subprocess with this environment.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the heat_tpu_torch package
_ROOT = os.path.dirname(_PKG)  # the directory holding it: the workers import heat_tpu_torch from here
N_PROC = 2
MARKER = "MPDRYRUN-OK"
TRAIN_MARKER = "TRAIN-OK"
SERVE_MARKER = "SERVE-OK"
FED_SERVE_MARKER = "FEDSERVE-OK"
PASS_MARKER = "CHAOS WORLD: PASS"
FAIL_MARKER = "CHAOS WORLD: FAIL"
DEVICE = "gpu"  # the workers' device where MPDRYRUN_DEVICE does not name one, as the port's entry points


def _device() -> str:
    return os.environ.get("MPDRYRUN_DEVICE", DEVICE)


def _load_standalone(modname: str, relpath: str):
    """A stdlib-only module of the package (supervisor, telemetry, ...) by
    path: the launcher never imports torch."""
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, os.path.join(_PKG, relpath))
    mod = importlib.util.module_from_spec(spec)
    # registered BEFORE exec: dataclasses (supervisor.SupervisorResult)
    # resolve their defining module through sys.modules
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def _supervisor_mod():
    return _load_standalone("heat_world_supervisor", "parallel/supervisor.py")


def launch(timeout: float = 540.0, n_proc: int = N_PROC, mode: str = "postmortem", extra_env: dict = None,
           device: str = None):
    """Run the launcher as a subprocess: ``n_proc`` ranks of ``mode`` with
    ``extra_env`` (the ``MPDRYRUN_*`` settings) on ``device`` ("gpu" or
    "cpu"; None: ``MPDRYRUN_DEVICE`` of the environment, else the card).
    Returns the ``CompletedProcess``; success is ``returncode == 0`` and
    ``PASS_MARKER`` in its stdout."""
    import signal

    env = dict(os.environ)
    env["MPDRYRUN_NPROC"] = str(n_proc)
    env["MPDRYRUN_MODE"] = mode
    if device:
        env["MPDRYRUN_DEVICE"] = device
    if extra_env:
        env.update({k: str(v) for k, v in extra_env.items()})
    # a session of its own: on a timeout the launcher and every worker it
    # started go down together, none is left behind
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=_ROOT, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


# ---------------------------------------------------------------------- #
# workers
# ---------------------------------------------------------------------- #
def _bring_up(pid: int, port: int, n_proc: int):
    """The worker's watchdog, then the port on its device joined to the
    world over gloo; returns (ht, comm, heartbeat)."""
    import faulthandler
    import signal

    # a stack dump on the supervisor's request before a kill, and a
    # self-watchdog: a collective that never completes dumps and exits
    faulthandler.register(signal.SIGUSR1)
    faulthandler.dump_traceback_later(float(os.environ.get("MPDRYRUN_WATCHDOG", "450")), exit=True)
    sys.path.insert(0, _ROOT)
    import heat_tpu_torch as ht
    from heat_tpu_torch.core import bootstrap

    import torch

    device = _device()
    ht.use_device(device)
    if device == "gpu":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores: one intra-op thread each, as torchrun sets
    bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=n_proc, rank=pid, backend="gloo")
    from heat_tpu_torch.utils import health

    hb = health.Heartbeat(os.path.join(os.environ["MPDRYRUN_HB"], f"rank{pid}.json"))
    hb.beat(step=0, status="bring-up")
    return ht, ht.communication.get_comm(), hb


def _finish(ht, pid: int) -> None:
    import faulthandler

    print(f"[{pid}] {MARKER}", flush=True)
    faulthandler.cancel_dump_traceback_later()
    ht.core.bootstrap.finalize_distributed()


def postmortem_worker(pid: int, port: int, tmpdir: str) -> None:
    """Every rank the same loop of ``MPDRYRUN_PM_ITERS`` ``resplit_`` flips
    of a (p, p) float32 array, one accounted collective (an ``Alltoall``)
    an iteration, each stamped into the flight ring before it is issued and
    marked ``enter`` as it goes into the transport.  At iteration
    ``MPDRYRUN_CHAOS_AT``:

    - ``MPDRYRUN_HANG_RANK=k``: rank k arms a ``comm.collective`` hang and
      flips once more; the stamp lands in its ring first, so the ring's
      last record is the collective it hung on (``PM-HANG expect_seq=N``).
      The flips block until every rank joins, so its peers stamp seq N too
      and wait in its transport: the analyzer names rank k, the one rank
      without an ``enter`` record at seq N, the straggler at seq N.
    - ``MPDRYRUN_DESYNC_RANK=k``: rank k resplits one extra array of another
      shape to None (an ``Allgather``), which its peers never post
      (``PM-DESYNC expect_seq=N``): at seq N its fingerprint differs, and
      the analyzer names seq N the first divergence and rank k the minority.

    After a chaos injection every rank parks or waits in a transport (no
    beats, no teardown): the supervisor's heartbeat staleness must notice,
    tear the world down and run the analyzer on the harvested rings."""
    import time

    # the beacon exists before the heavy imports: bring-up alone may take a
    # good part of the scenarios' short heartbeat timeout
    hb_dir = os.environ["MPDRYRUN_HB"]
    os.makedirs(hb_dir, exist_ok=True)
    with open(os.path.join(hb_dir, f"rank{pid}.json"), "a"):
        pass
    n_proc = int(os.environ.get("MPDRYRUN_NPROC", N_PROC))
    ht, comm, hb = _bring_up(pid, port, n_proc)
    from heat_tpu_torch.utils import faults, flightrec

    if not flightrec.enabled():
        raise RuntimeError("postmortem mode needs HEAT_TPU_FLIGHTREC_DIR")
    hang_rank = int(os.environ.get("MPDRYRUN_HANG_RANK", "-1"))
    desync_rank = int(os.environ.get("MPDRYRUN_DESYNC_RANK", "-1"))
    chaos_at = int(os.environ.get("MPDRYRUN_CHAOS_AT", "3"))
    n_iters = int(os.environ.get("MPDRYRUN_PM_ITERS", "6"))
    chaos = hang_rank >= 0 or desync_rank >= 0
    m = ht.reshape(ht.arange(comm.size * comm.size, dtype=ht.float32, split=0), (comm.size, comm.size))
    last = flightrec.last_collective()
    seq0 = last[0] if last else 0
    print(f"[{pid}] PM-LOOP start seq0={seq0}", flush=True)
    for i in range(n_iters):
        if pid == hang_rank and i == chaos_at:
            # the stamp is written before the fault site fires, so the
            # ring's last record IS the collective this rank hung on
            print(f"[{pid}] PM-HANG expect_seq={seq0 + i + 1}", flush=True)
            with faults.inject("comm.collective", hang=1):
                m.resplit_(1 if m.split == 0 else 0)
            raise AssertionError("unreachable: the collective was armed to hang")
        if pid == desync_rank and i == chaos_at:
            print(f"[{pid}] PM-DESYNC expect_seq={seq0 + i + 1}", flush=True)
            # the rank-conditional EXTRA collective: another op of another
            # shape, so the divergent fingerprint differs in its payload,
            # not only in its order
            ht.arange(comm.size, dtype=ht.float32, split=0).resplit_(None)
        m.resplit_(1 if m.split == 0 else 0)
        hb.beat(step=i)
    last = flightrec.last_collective()
    print(f"[{pid}] FLIGHTREC seq={last[0]} op={last[1]}", flush=True)
    if chaos:
        # park: a clean teardown would need the wedged or diverged peers'
        # collectives.  Beats stop here on purpose: heartbeat staleness is
        # the signal the supervisor must turn into teardown and a verdict
        print(f"[{pid}] PM-PARK", flush=True)
        while True:
            time.sleep(60.0)
    _finish(ht, pid)


def serve_worker(pid: int, port: int, tmpdir: str) -> None:
    """Multi-tenant serving under the supervising launcher: every rank runs
    the identical scheduler over the identical submissions of
    ``serve_world.job_stream(MPDRYRUN_JOBS)`` (its queue bound sheds the
    last tenth), rank 0 journals, and on ``HEAT_TPU_RESTART_EPOCH > 0``
    every rank replays rank 0's journal and requeues the accepted but
    unfinished jobs exactly once instead of resubmitting.  One accounted
    resplit before and after the drain brackets every rank's ring, so the
    rings prove the ranks entered and left the serving loop in lockstep."""
    n_proc = int(os.environ.get("MPDRYRUN_NPROC", N_PROC))
    ht, comm, hb = _bring_up(pid, port, n_proc)
    from heat_tpu_torch.parallel import scheduler as sched_mod
    from heat_tpu_torch.parallel import serve_world, serving
    from heat_tpu_torch.utils import telemetry

    telemetry.enable()
    n_jobs = int(os.environ.get("MPDRYRUN_JOBS", "20"))
    journal_path = os.path.join(tmpdir, "telemetry", "sched_journal.jsonl")
    epoch = ht.core.bootstrap.restart_epoch()
    sch = sched_mod.Scheduler(
        serving.make_executor(comm),
        max_queue=serve_world.queue_bound(n_jobs),
        max_batch=serve_world.MAX_BATCH,
        # one journal per world, written by rank 0: the ranks schedule in
        # lockstep, so one rank's record stream is the truth; every rank
        # READS it on recovery
        journal=sched_mod.JobJournal(journal_path, epoch=epoch) if pid == 0 else None,
        batch_key=serving.batch_key,
    )

    def _lockstep_stamp():
        ht.reshape(ht.arange(comm.size * comm.size, dtype=ht.float32, split=0), (comm.size, comm.size)).resplit(1)

    _lockstep_stamp()
    requeued = 0
    if epoch > 0:
        requeued = sch.recover(journal_path, epoch=epoch)
        print(f"[{pid}] SCHED-RECOVERED epoch={epoch} requeued={requeued}", flush=True)
    else:
        for spec in serve_world.job_stream(n_jobs):
            try:
                sch.submit(serve_world._job(spec))
            except sched_mod.JobRejected as e:
                # load shedding is an immediate structured answer: the
                # submit loop goes on
                print(f"[{pid}] SCHED-SHED id={e.job_id} reason={e.reason}", flush=True)
    hb.beat(status="serving")
    rep = sch.run(beat=hb.beat)
    _lockstep_stamp()
    done = rep["by_state"].get(sched_mod.DONE, 0)
    failed = rep["by_state"].get(sched_mod.FAILED, 0)
    shed = rep["by_state"].get(sched_mod.SHED, 0)
    print(f"[{pid}] {SERVE_MARKER} jobs={len(rep['jobs'])} done={done} failed={failed} shed={shed} "
          f"requeued={requeued} reconciled={rep['reconciled']}", flush=True)
    telemetry.flush(os.path.join(tmpdir, "telemetry"))
    print(f"[{pid}] telemetry: rank file exported", flush=True)
    _finish(ht, pid)


def fed_serve_worker(pid: int, port: int, tmpdir: str) -> None:
    """One rank of one federated world: the scheduler over the job slice
    the federation assigned to this world (``MPDRYRUN_FED_JOBS``: the
    submit records it journaled, trace ids minted at the HTTP edge),
    journaling into the world's own journal (``MPDRYRUN_FED_JOURNAL``),
    which the federation later reconciles."""
    import json

    n_proc = int(os.environ.get("MPDRYRUN_NPROC", "1"))
    world = os.environ.get("MPDRYRUN_FED_WORLD", "w?")
    ht, comm, hb = _bring_up(pid, port, n_proc)
    from heat_tpu_torch.parallel import scheduler as sched_mod
    from heat_tpu_torch.parallel import serving
    from heat_tpu_torch.utils import telemetry

    telemetry.enable()
    with open(os.environ["MPDRYRUN_FED_JOBS"]) as fh:
        records = json.load(fh)
    journal_path = os.environ["MPDRYRUN_FED_JOURNAL"]
    sch = sched_mod.Scheduler(
        serving.make_executor(comm),
        max_queue=max(len(records) + 2, 8),
        max_batch=4,
        journal=sched_mod.JobJournal(journal_path, epoch=ht.core.bootstrap.restart_epoch()) if pid == 0 else None,
        batch_key=serving.batch_key,
    )
    for rec in records:
        # from_record keeps the edge-minted trace id: the federation journal,
        # this world's journal and the flight rings correlate on one id
        sch.submit(sched_mod.Job.from_record(rec))
    hb.beat(status="serving")
    rep = sch.run(beat=hb.beat)
    done = rep["by_state"].get(sched_mod.DONE, 0)
    failed = rep["by_state"].get(sched_mod.FAILED, 0)
    print(f"[{pid}] {FED_SERVE_MARKER} world={world} jobs={len(rep['jobs'])} done={done} failed={failed}",
          flush=True)
    telemetry.flush(os.path.join(tmpdir, "telemetry"))
    _finish(ht, pid)


def train_worker(pid: int, port: int, tmpdir: str) -> None:
    """DASO training under the supervising launcher: a small model to
    ``MPDRYRUN_TARGET_STEPS`` with ``checkpoint_every=MPDRYRUN_CKPT_EVERY``
    checkpoints into a directory shared across ranks and generations, one
    group a rank (the slow tier crosses the process seam).  On
    ``HEAT_TPU_RESTART_EPOCH > 0`` the worker resumes from the newest
    verified checkpoint (``RESUMED epoch=K step=N``): a rank SIGKILLed
    mid-training (fault site ``proc.exit``) costs at most
    ``checkpoint_every`` steps, not the run."""
    import time

    import numpy as np

    n_proc = int(os.environ.get("MPDRYRUN_NPROC", N_PROC))
    ht, comm, hb = _bring_up(pid, port, n_proc)
    import torch

    from heat_tpu_torch.utils import telemetry

    telemetry.enable()
    target = int(os.environ.get("MPDRYRUN_TARGET_STEPS", "12"))
    ck_every = int(os.environ.get("MPDRYRUN_CKPT_EVERY", "3"))
    step_delay = float(os.environ.get("MPDRYRUN_STEP_DELAY", "0.05"))
    ckpt_dir = os.path.join(tmpdir, "daso_ckpt")
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 4))
    if _device() == "gpu":
        model = model.cuda()
    daso = ht.optim.DASO(ht.optim.DataParallelOptimizer("sgd", lr=0.05), total_local_comm_size=1, warmup_steps=1,
                         global_skip=2, stale_steps=1, checkpoint_every=ck_every, checkpoint_dir=ckpt_dir)
    daso.init(model)
    epoch = ht.core.bootstrap.restart_epoch()
    if epoch > 0:
        resumed = daso.resume()
        print(f"[{pid}] RESUMED epoch={epoch} step={daso._step_count} ok={resumed}", flush=True)
    # SPMD-identical rows on every rank
    rng = np.random.default_rng(0)
    dev = next(model.parameters()).device
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32)).to(dev)
    loss_fn = torch.nn.functional.mse_loss
    while daso._step_count < target:
        loss = daso.step(loss_fn, x, y)
        float(loss)  # lockstep: the beat below attests a completed step
        hb.beat(step=daso._step_count)
        if step_delay:
            time.sleep(step_delay)  # widens the kill window deterministically
    print(f"[{pid}] {TRAIN_MARKER} steps={daso._step_count}", flush=True)
    telemetry.flush(os.path.join(tmpdir, "telemetry"))
    print(f"[{pid}] telemetry: rank file exported", flush=True)
    _finish(ht, pid)


# ---------------------------------------------------------------------- #
# the federated launcher
# ---------------------------------------------------------------------- #
def _http(method: str, url: str, payload: dict = None, timeout: float = 15.0):
    """(status, parsed-JSON body): errors like 429 and 503 are answers here
    (the structured backpressure under test), not exceptions."""
    import json
    import urllib.error
    import urllib.request

    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read().decode()
            code = resp.status
    except urllib.error.HTTPError as e:
        raw = e.read().decode()
        code = e.code
    try:
        return code, json.loads(raw or "{}")
    except ValueError:
        return code, raw  # /metrics is Prometheus text, not JSON


def _fed_jobs(n_jobs: int) -> list:
    """The federated scenario's submissions: ``serve_world.job_stream``'s
    kinds, tenants, priorities and sizes, as ingress payloads."""
    stream = _load_standalone("heat_world_serve_world", "parallel/serve_world.py")
    return [{"id": j["id"], "kind": j["kind"], "tenant": j["tenant"], "priority": j["priority"], "deadline_s": 600,
             "retry_budget": j["retry_budget"], "payload": j["payload"]} for j in stream.job_stream(n_jobs)]


def fed_main() -> int:
    """Two supervised worlds behind one HTTP ingress.

    Phase 1: ``MPDRYRUN_JOBS`` jobs POSTed to ``/submit`` (plus one
    ``giant`` job shed ``mem_infeasible`` at the edge: HTTP 429,
    structured), assigned across both worlds; world w1 is armed with
    ``sched.dispatch:exit=2`` and no restart budget, so its rank dies by
    SIGKILL mid-queue and the supervisor gives up: a whole world lost.
    Phase 2: the federation reconciles both world journals, quarantines
    w1, steals its unfinished jobs, resizes w0 up, and serves them.  The
    run passes iff the journal-replayed attestation reads ``FED worlds=2
    lost=0`` and ``/result/<id>`` serves a stolen job's digest over HTTP."""
    import json
    import tempfile
    import threading

    ok = True
    tmpdir = tempfile.mkdtemp(prefix="chaos_world_fed_")
    n_jobs = int(os.environ.get("MPDRYRUN_JOBS", "12"))
    gen_deadline = float(os.environ.get("MPDRYRUN_DEADLINE", "420"))
    fed_dir = os.path.join(tmpdir, "fed")
    os.makedirs(fed_dir, exist_ok=True)
    peaks_path = os.path.join(fed_dir, "peaks.json")
    # the per-kind peak history: `giant` is known to peak at ~1 TiB, so no
    # 8 GiB world fits it and admission must shed it at the edge
    with open(peaks_path, "w") as fh:
        json.dump({"giant": 1 << 40}, fh)

    fed_mod = _load_standalone("heat_world_federation", "parallel/federation.py")
    mon_mod = _load_standalone("heat_world_monitor", "utils/monitor.py")
    sup_mod = _supervisor_mod()

    worlds = {}
    for name in ("w0", "w1"):
        wdir = os.path.join(tmpdir, name)
        worlds[name] = {"dir": wdir, "hb": os.path.join(wdir, "heartbeats"), "fr": os.path.join(wdir, "flightrec"),
                        "journal": os.path.join(wdir, "telemetry", "sched_journal.jsonl")}
        os.makedirs(worlds[name]["hb"], exist_ok=True)

    fed = fed_mod.Federation(os.path.join(fed_dir, "fed_journal.jsonl"), max_queue=max(32, n_jobs + 4),
                             predictor=fed_mod.AdmissionPredictor(peaks_path))
    for name, w in worlds.items():
        fed.add_world(name, n_ranks=1, capacity_bytes=8 << 30, heartbeat_dir=w["hb"], journal_path=w["journal"])

    # the ingress: the monitor's HTTP server with the federation behind it
    mon = mon_mod.Monitor(port=0)
    mon_mod.set_ingress(fed)
    mon_mod.set_federation_source(fed.health_report)
    url = mon.url
    submitted = 0
    for job in _fed_jobs(n_jobs):
        code, body = _http("POST", f"{url}/submit", job)
        if code != 200 or not body.get("trace_id"):
            print(f"fed: POST /submit {job['id']} -> {code} {body}")
            ok = False
        else:
            submitted += 1
    print(f"FED-INGRESS url={url} submitted={submitted}", flush=True)
    code, body = _http("POST", f"{url}/submit", {"id": "giant", "kind": "giant", "tenant": "alpha", "payload": {}})
    if code == 429 and body.get("error") == "mem_infeasible":
        print(f"FED-SHED id=giant reason={body['error']} http={code}", flush=True)
    else:
        print(f"fed: giant job expected 429 mem_infeasible, got {code} {body}")
        ok = False
    code, body = _http("GET", f"{url}/status/job000")
    if code != 200 or body.get("state") != "submitted":
        print(f"fed: GET /status/job000 -> {code} {body}")
        ok = False
    code, body = _http("GET", f"{url}/healthz")
    print(f"FED-HEALTHZ http={code} detail={body.get('detail', '')!r}", flush=True)
    ok = ok and code == 200

    assignment = fed.assign()
    log_paths, open_logs = [], []

    def make_spawn(name: str, jobs_file: str, armed: bool, tag: str = "p1"):
        w = worlds[name]

        def spawn(rank: int, epoch: int, port: int):
            env = dict(os.environ)
            env.update(MPDRYRUN_PORT=str(port), MPDRYRUN_TMP=w["dir"], MPDRYRUN_HB=w["hb"],
                       MPDRYRUN_NPROC=str(fed.worlds[name].n_ranks), MPDRYRUN_FED_WORLD=name,
                       MPDRYRUN_FED_JOBS=jobs_file, MPDRYRUN_FED_JOURNAL=w["journal"], HEAT_TPU_FLIGHTREC_DIR=w["fr"],
                       HEAT_TPU_FLIGHTREC_RANK=str(rank), HEAT_TPU_MEMLEDGER="1", HEAT_TPU_FED_PEAKS=peaks_path,
                       HEAT_TPU_RESTART_EPOCH=str(epoch), PYTHONUNBUFFERED="1")
            if armed and epoch == 0:
                env["HEAT_TPU_FAULTS"] = "sched.dispatch:exit=2"
            else:
                env.pop("HEAT_TPU_FAULTS", None)
            path = os.path.join(w["dir"], f"{tag}_epoch{epoch}_rank{rank}.log")
            log = open(path, "wb")
            log_paths.append((f"{name} {tag}", epoch, rank, path))
            open_logs.append(log)
            return subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank)], env=env, stdout=log,
                                    stderr=subprocess.STDOUT)

        return spawn

    def write_jobs(name: str, tag: str) -> str:
        path = os.path.join(fed_dir, f"{name}_jobs_{tag}.json")
        with open(path, "w") as fh:
            json.dump([j.to_submit_record() for j in assignment.get(name, [])], fh)
        return path

    def run_world(name: str, armed: bool, results: dict):
        w = worlds[name]
        sup = sup_mod.Supervisor(
            make_spawn(name, write_jobs(name, "p1"), armed), fed.worlds[name].n_ranks, heartbeat_dir=w["hb"],
            heartbeat_timeout=float(os.environ.get("MPDRYRUN_HB_TIMEOUT", "120")),
            # w1 is the victim: no restart budget, so its killed generation
            # is the world's last and the federation must absorb it
            restart_budget=0 if armed else 1, generation_deadline=gen_deadline, flightrec_dir=w["fr"],
            telemetry_dir=os.path.join(w["dir"], "telemetry"))
        results[name] = sup.run()

    results: dict = {}
    threads = [threading.Thread(target=run_world, args=("w0", False, results)),
               threading.Thread(target=run_world, args=("w1", True, results))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for log in open_logs:
        log.close()

    res0, res1 = results.get("w0"), results.get("w1")
    if res0 is None or not res0.ok:
        print("fed: world w0 (the healthy world) failed its generation")
        ok = False
    if res1 is None or res1.ok:
        print("fed: world w1 was armed to die and didn't")
        ok = False
    # fold both world journals into the federation journal, then the
    # victim's post-mortem verdicts and its death into the health model
    for name in ("w0", "w1"):
        r = fed.reconcile_world_journal(name)
        print(f"FED-RECONCILED world={name} done={r['done']} failed={r['failed']}", flush=True)
    if res1 is not None:
        for pm in res1.postmortems:
            fed.note_verdict("w1", pm)
    stolen = fed.world_lost("w1", "supervisor gave up: every rank SIGKILLed")
    print(f"FED-QUARANTINED world=w1 stolen={stolen}", flush=True)
    if stolen < 1:
        print("fed: the killed world held no unfinished jobs to steal: the kill landed after its queue drained")
        ok = False

    # the quarantined world must not gate /healthz, and the federation's
    # gauges must reconcile with its census
    code, body = _http("GET", f"{url}/healthz")
    fedrep = body.get("federation", {})
    print(f"FED-HEALTHZ-DEGRADED http={code} healthy={fedrep.get('healthy')} "
          f"quarantined={fedrep.get('quarantined')}", flush=True)
    ok = ok and code == 200 and fedrep.get("quarantined") == 1
    code, metrics = _http("GET", f"{url}/metrics")
    metrics = metrics if isinstance(metrics, str) else ""
    if "fed_worlds_healthy 1" not in metrics or "fed_worlds_quarantined 1" not in metrics:
        print(f"fed: /metrics fed_worlds_* gauges missing: {metrics[:400]}")
        ok = False

    # elastic resize: capacity follows the journal-derived queue depth, so
    # the stolen jobs land on a grown w0 (applied between generations)
    plan = fed.resize_plan(jobs_per_rank=1, max_ranks=2)
    new_ranks = plan.get("w0", 1)
    print(f"FED-RESIZE world=w0 ranks={fed.worlds['w0'].n_ranks}->{new_ranks} queue={len(fed._queue)}", flush=True)
    fed.worlds["w0"].n_ranks = new_ranks
    assignment = fed.assign()
    if assignment.get("w1"):
        print("fed: assign() handed jobs to the quarantined world")
        ok = False
    res2 = sup_mod.Supervisor(
        make_spawn("w0", write_jobs("w0", "p2"), False, tag="p2"), new_ranks, heartbeat_dir=worlds["w0"]["hb"],
        restart_budget=1, generation_deadline=gen_deadline, flightrec_dir=worlds["w0"]["fr"],
        telemetry_dir=os.path.join(worlds["w0"]["dir"], "telemetry")).run()
    for log in open_logs:
        log.close()  # closing twice is a no-op: phase 1's logs are closed already
    if not res2.ok:
        print("fed: resized w0 failed to serve the stolen jobs")
        ok = False
    r = fed.reconcile_world_journal("w0")
    print(f"FED-RECONCILED world=w0 done={r['done']} failed={r['failed']}", flush=True)

    # a stolen job's answer must be servable over HTTP from the journaled
    # DONE record: the crash-surviving result path
    stolen_ids = sorted(rec["id"] for rec in fed_mod.replay_federation(fed.journal.path)["records"]
                        if rec.get("type") == "requeue")
    if stolen_ids:
        code, body = _http("GET", f"{url}/result/{stolen_ids[0]}")
        digest = (body.get("result") or {}).get("digest")
        print(f"FED-RESULT id={stolen_ids[0]} http={code} digest={digest}", flush=True)
        if code != 200 or digest is None:
            ok = False
    code, body = _http("GET", f"{url}/result/never-submitted")
    if code != 404:
        print(f"fed: unknown id served {code} {body}")
        ok = False

    for name, epoch, rank, path in log_paths:
        with open(path, "rb") as fh:
            text = fh.read().decode(errors="replace")
        sys.stdout.write(f"---- {name} epoch {epoch} rank {rank} ----\n{text}")

    # the zero-loss attestation, from the federation journal alone
    print(fed.attestation(), flush=True)
    summary = fed_mod.fed_summary(fed_mod.replay_federation(fed.journal.path))
    if summary["lost"] != 0:
        print("fed: accepted job(s) lost across the federation: the zero-loss contract is broken")
        ok = False
    if summary["worlds"] != 2 or summary["jobs"] != n_jobs + 1 or summary["shed"] != 1:
        print(f"fed: attestation accounting off: {summary}")
        ok = False
    mon_mod.clear_ingress()
    mon_mod.clear_federation_source()
    mon.close()
    print(PASS_MARKER if ok else FAIL_MARKER, flush=True)
    return 0 if ok else 1


# ---------------------------------------------------------------------- #
# the launcher: a Supervisor owns the world
# ---------------------------------------------------------------------- #
def main() -> int:
    import json
    import tempfile

    n_proc = int(os.environ.get("MPDRYRUN_NPROC", N_PROC))
    mode = os.environ.get("MPDRYRUN_MODE", "postmortem")
    if mode == "fed":
        return fed_main()
    if mode not in ("train", "serve", "postmortem"):
        raise SystemExit(f"MPDRYRUN_MODE must be train, serve, postmortem or fed, got {mode!r}")
    tmpdir = tempfile.mkdtemp(prefix="chaos_world_")
    hb_dir = os.path.join(tmpdir, "heartbeats")
    fr_dir = os.path.join(tmpdir, "flightrec")
    tdir = os.path.join(tmpdir, "telemetry")
    restart_budget = int(os.environ.get("MPDRYRUN_RESTARTS", "2" if mode in ("train", "serve") else "0"))
    # serve mode: rank 0's scheduler journals into the telemetry dir (the
    # attestation, the supervisor's jobs section and the SLO table read it)
    job_journal = os.path.join(tdir, "sched_journal.jsonl") if mode == "serve" else None
    # a generation deadline below the callers' timeout: a hang is reaped by
    # this launcher, which can kill its children
    gen_deadline = float(os.environ.get("MPDRYRUN_DEADLINE", "480"))
    hb_timeout = float(os.environ.get("MPDRYRUN_HB_TIMEOUT", "120"))
    fault_rank = int(os.environ.get("MPDRYRUN_FAULT_RANK", "-1"))
    fault_spec = os.environ.get("MPDRYRUN_FAULT_SPEC", "")
    if fault_spec:
        # a typo'd site would arm nothing and the scenario would test a
        # healthy world: refuse it at launch
        flt = _load_standalone("heat_world_faults", "utils/faults.py")
        unknown = sorted(set(flt.parse_spec(fault_spec)) - set(flt.catalog_sites()))
        if unknown:
            raise SystemExit(f"MPDRYRUN_FAULT_SPEC names unknown fault site(s) {unknown}; "
                             f"catalog: {sorted(flt.catalog_sites())}")
    # by default the injected fault models ONE crash (disarmed on restart);
    # =1 keeps it armed every generation: a persistently bad node, which
    # must exhaust the restart budget and end in the give-up report
    fault_every_epoch = os.environ.get("MPDRYRUN_FAULT_EVERY_EPOCH", "0") == "1"
    sup_mod = _supervisor_mod()
    log_paths, open_logs = [], []  # (epoch, rank, path) in launch order

    def spawn(rank: int, epoch: int, port: int):
        env = dict(os.environ)
        env.update(MPDRYRUN_PORT=str(port), MPDRYRUN_TMP=tmpdir, MPDRYRUN_HB=hb_dir,
                   # the black box: every collective seq-stamped into a
                   # crash-durable ring under fr_dir
                   HEAT_TPU_FLIGHTREC_DIR=fr_dir, HEAT_TPU_FLIGHTREC_RANK=str(rank), HEAT_TPU_MEMLEDGER="1",
                   HEAT_TPU_RESTART_EPOCH=str(epoch), PYTHONUNBUFFERED="1")
        if rank == fault_rank and fault_spec and (epoch == 0 or fault_every_epoch):
            env["HEAT_TPU_FAULTS"] = fault_spec
        else:
            # a restarted rank must not re-arm the fault that killed it
            env.pop("HEAT_TPU_FAULTS", None)
        path = os.path.join(tmpdir, f"epoch{epoch}_rank{rank}.log")
        log = open(path, "wb")
        log_paths.append((epoch, rank, path))
        open_logs.append(log)
        return subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank)], env=env, stdout=log,
                                stderr=subprocess.STDOUT)

    sup = sup_mod.Supervisor(spawn, n_proc, heartbeat_dir=hb_dir, heartbeat_timeout=hb_timeout,
                             restart_budget=restart_budget, generation_deadline=gen_deadline,
                             flightrec_dir=fr_dir, telemetry_dir=tdir, job_journal=job_journal)
    res = sup.run()
    for log in open_logs:
        log.close()
    # every generation's logs in order: epoch 0's kill diagnostics and the
    # final generation's markers both matter
    final_epoch = max(e for e, _, _ in log_paths) if log_paths else 0
    final_texts = {}
    for epoch, rank, path in log_paths:
        with open(path, "rb") as fh:
            text = fh.read().decode(errors="replace")
        sys.stdout.write(f"---- epoch {epoch} rank {rank} ----\n{text}")
        if epoch == final_epoch:
            final_texts[rank] = text
    ok = res.ok
    want = TRAIN_MARKER if mode == "train" else MARKER
    for rank in range(n_proc):
        if f"[{rank}] {want}" not in final_texts.get(rank, ""):
            print(f"launcher: rank {rank} never printed its {want} marker")
            ok = False
    # the supervisor's counters (restarts, watchdog.dumps and .kills) ride
    # the telemetry merge as rank n_proc, outside the workers', so last-wins
    # merging never shadows a rank's
    launcher_counters = dict(res.counters)
    trep = _load_standalone("heat_world_telemetry_report", "analysis/telemetry_report.py")
    tele = _load_standalone("heat_world_telemetry", "utils/telemetry.py")
    tele.write_counters_line(tdir, n_proc, launcher_counters)
    merged = trep.merge_files(trep.find_rank_files(tdir))
    print(trep.render(merged, top=10, timeline=0), flush=True)
    worker_ranks = [r for r in merged["ranks"] if r < n_proc]
    if ok and len(worker_ranks) != n_proc:
        print(f"telemetry merge: expected {n_proc} worker ranks, got {merged['ranks']}")
        ok = False
    elif ok:
        print(f"TELEMETRY-MERGED ranks={len(worker_ranks)}", flush=True)
    # the step-time breakdown from the merged spans: STEP-OVERLAP lines
    # whenever the run recorded step spans (daso.step, sched.job)
    overlap = trep.overlap_section(merged["timeline"])
    if overlap:
        print(overlap, flush=True)
    print(f"SUPERVISOR restarts={res.restarts} generations={res.generations} "
          f"watchdog.dumps={launcher_counters['watchdog.dumps']} "
          f"watchdog.kills={launcher_counters['watchdog.kills']}", flush=True)
    # serving attestation: every accepted job reached DONE or a named
    # FAILED across however many generations; one lost job fails the run
    if job_journal is not None:
        sched_mod = _load_standalone("heat_world_scheduler", "parallel/scheduler.py")
        if res.jobs is None:
            print("launcher: serve mode but no job journal was written")
            ok = False
        elif "error" in res.jobs:
            print(f"launcher: job journal unreadable: {res.jobs['error']}")
            ok = False
        else:
            print(sched_mod.attestation_line(res.jobs), flush=True)
            if ok and res.jobs["lost"] != 0:
                print("launcher: accepted job(s) neither DONE nor FAILED: the zero-loss contract is broken")
                ok = False
            expected_jobs = int(os.environ.get("MPDRYRUN_JOBS", "20"))
            if ok and res.jobs["jobs"] != expected_jobs:
                print(f"launcher: journal saw {res.jobs['jobs']} of {expected_jobs} submitted jobs")
                ok = False
        slo = trep.slo_section([tdir], spans=merged["timeline"])
        if slo:
            print(slo, flush=True)
        # every journaled record of one job, across generations, carries
        # one trace id, and one trace id assembles into a causal timeline
        # across journal, telemetry and rings; a requeued job preferred,
        # since its chain crosses the restart
        if os.path.exists(job_journal):
            replay = sched_mod.replay_journal(job_journal)
            cont = sched_mod.trace_continuity(replay)
            print(f"SCHED-TRACE-CONTINUITY jobs={cont['jobs']} ok={cont['ok']}"
                  + (f" violations={cont['violations']}" if cont["violations"] else ""), flush=True)
            if not cont["ok"]:
                print("launcher: requeued job(s) changed trace id across the restart")
                ok = False
            requeued_tids = [rec.get("tid") for rec in replay["records"]
                             if rec.get("type") == "requeue" and rec.get("tid")]
            any_tids = [v.get("tid") for v in replay["jobs"].values() if v.get("tid")]
            pick = (requeued_tids or any_tids or [None])[0]
            if pick:
                print(trep.trace_section([tdir, fr_dir], pick, spans=merged["timeline"]), flush=True)
    # the ring post-mortem: failed generations were analyzed and harvested
    # by the supervisor at teardown; a green run's final rings are analyzed
    # now, so it ends with an explicit clean verdict
    pm = _load_standalone("heat_world_postmortem", "analysis/postmortem.py")
    for v in res.postmortems:
        print(pm.summary_line(v, epoch=v.get("epoch")), flush=True)
    if res.ok:
        verdict = pm.analyze_dir(fr_dir, heartbeat_dir=hb_dir, telemetry_dir=tdir,
                                 expected_ranks=list(range(n_proc)))
        print(pm.summary_line(verdict), flush=True)
        if verdict.get("verdict") != "clean" and ok:
            print("launcher: postmortem disagrees with the green markers:")
            print(pm.render(verdict))
            ok = False
    if not res.ok:
        print("SUPERVISOR GAVE UP; diagnostic report:", flush=True)
        print(json.dumps(res.report(), indent=2), flush=True)
    # the cross-rank timeline: clocks aligned on the shared collective
    # stamps, the gating rank, op and seq named, the Chrome trace exported,
    # on failed runs too (the harvested epoch<N>/ rings are folded in)
    try:
        tl = _load_standalone("heat_world_timeline", "analysis/timeline.py")
        bundle = tl.assemble([tdir, fr_dir])
        clock = tl.clock_report(bundle)
        if clock:
            print(clock, flush=True)
        cp_report = tl.critical_path_report(bundle)
        if cp_report:
            print(cp_report, flush=True)
        trace = tl.to_chrome_trace(bundle)
        problems = tl.validate_chrome_trace(trace)
        trace_out = os.environ.get("MPDRYRUN_TRACE_OUT") or os.path.join(tmpdir, "trace.json")
        with open(trace_out, "w") as fh:
            json.dump(trace, fh)
        print(f"TRACE-EXPORT events={len(trace['traceEvents'])} ranks={len(bundle['ranks'])} out={trace_out}",
              flush=True)
        for p in problems:
            print(f"launcher: trace INVALID: {p}")
            ok = False
    except Exception as e:  # the attestation must print whatever the timeline does
        print(f"launcher: timeline export failed: {e!r}")
        ok = False
    print(PASS_MARKER if ok else FAIL_MARKER, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 1:
        _target = {"train": train_worker, "postmortem": postmortem_worker, "serve": serve_worker,
                   "fed": fed_serve_worker}[os.environ.get("MPDRYRUN_MODE", "postmortem")]
        _target(int(sys.argv[1]), int(os.environ["MPDRYRUN_PORT"]), os.environ["MPDRYRUN_TMP"])
    else:
        sys.exit(main())
