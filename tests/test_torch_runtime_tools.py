"""The port's runtime files against the reference's own tools, and the port's
serving executors against the reference's.

- One scripted job stream (three tenants, shedding, a transient dispatch
  fault, a job that fails, deadlines) with a fake executor and a fake clock
  through the port's and the reference's ``Scheduler``: equal journals
  (timestamps aside), equal ``jobs_summary``; each journal replays in the
  other package's ``replay_journal`` to the same view.
- The port's telemetry rank files merged by the reference's stdlib CLI
  ``scripts/telemetry_report.py`` give the port's own ``report()`` counters.
- The port's flight ring read by the reference's ``scripts/postmortem.py``.
- ``make_executor`` at world size 1 on the CPU against the reference's on
  its 8-device CPU mesh: each kind's digest within 1e-5 relative, with
  ``nn_forward`` on the reference's parameters.
- The port's ``dist.init`` fault site, and the transport errors that map
  to ``WorldBroken`` (and the job errors that do not).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from heat_tpu.parallel import scheduler as ref_sched
from heat_tpu.parallel import serving as ref_serving
from heat_tpu.utils import faults as ref_faults

import heat_tpu_torch as htt
from heat_tpu_torch.parallel import scheduler as port_sched
from heat_tpu_torch.parallel import serving as port_serving
from heat_tpu_torch.utils import faults as port_faults
from heat_tpu_torch.utils import flightrec as port_flightrec
from heat_tpu_torch.utils import profiler as port_profiler
from heat_tpu_torch.utils import telemetry as port_telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_RTOL = 1e-5


def _script(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def on_cpu():
    prev = htt.get_device()
    htt.use_device("cpu")
    yield
    htt.use_device(prev)


# ---------------------------------------------------------------------- #
# one scripted job stream through both schedulers
# ---------------------------------------------------------------------- #
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _run_stream(S, faults, serving, journal):
    """Submit the stream, run it, return (journal records, summary, outcomes)."""

    def execute(jobs):
        out = []
        for j in jobs:
            if j.payload.get("bad"):
                raise ValueError(f"job {j.job_id} asked to fail")
            out.append({"digest": float(sum(map(ord, j.job_id)))})
        return out

    S.reset_counters()
    s = S.Scheduler(execute, journal=journal, max_queue=12, tenant_cap=5, max_batch=3,
                    batch_key=serving.batch_key, min_exec_estimate={"solve": 1.0}, clock=_Clock(),
                    retry_base_delay=0.0, retry_max_delay=0.0)
    shed = []
    kinds = ("matmul", "solve", "kmeans", "nn_forward")
    for i in range(18):
        tenant = ("alpha", "beta", "gamma")[i % 3]
        kind = kinds[i % 4]
        payload = {"n": 8 + 8 * (i % 2), "seed": i}
        if i == 7:
            payload["bad"] = True
        job = S.Job(f"job{i:02d}", kind, tenant=tenant, priority=i % 3,
                    deadline_s=0.5 if i == 5 else (60.0 if i % 5 == 0 else None), payload=payload)
        try:
            s.submit(job)
        except S.JobRejected as e:
            shed.append((e.job_id, e.reason))
    with faults.inject("sched.dispatch", fail=1):
        s.run()
    with open(journal) as fh:
        records = [json.loads(line) for line in fh if line.strip()]
    outcomes = {jid: s.outcome(jid) for jid in sorted(s._jobs)}
    return records, S.jobs_summary(S.replay_journal(journal)), outcomes, shed, S.counters()


def _untimed(rec):
    return {k: v for k, v in rec.items() if k not in ("t",) and not k.endswith("_t")}


def test_scripted_stream_gives_equal_journals_and_summaries(tmp_path):
    ref = _run_stream(ref_sched, ref_faults, ref_serving, str(tmp_path / "ref.jsonl"))
    port = _run_stream(port_sched, port_faults, port_serving, str(tmp_path / "port.jsonl"))
    assert [_untimed(r) for r in port[0]] == [_untimed(r) for r in ref[0]]
    assert port[1] == ref[1]
    assert port[3] == ref[3] and port[3]  # some jobs shed, the same ones, for the same reasons
    assert {k: (v["state"], v.get("reason")) for k, v in port[2].items()} == \
        {k: (v["state"], v.get("reason")) for k, v in ref[2].items()}
    assert port[4] == ref[4]
    states = {v["state"] for v in port[2].values()}
    assert "done" in states and "failed" in states
    assert port[1]["lost"] == 0 and port[1]["retried"] >= 1


def test_journals_replay_across_the_packages(tmp_path):
    _run_stream(ref_sched, ref_faults, ref_serving, str(tmp_path / "ref.jsonl"))
    _run_stream(port_sched, port_faults, port_serving, str(tmp_path / "port.jsonl"))
    for path in (tmp_path / "ref.jsonl", tmp_path / "port.jsonl"):
        a, b = ref_sched.replay_journal(str(path)), port_sched.replay_journal(str(path))
        assert a["jobs"] == b["jobs"] and a["torn"] == b["torn"]
        assert ref_sched.jobs_summary(a) == port_sched.jobs_summary(b)


# ---------------------------------------------------------------------- #
# telemetry files and flight rings through the reference's tools
# ---------------------------------------------------------------------- #
def test_port_telemetry_files_merge_in_the_reference_cli(tmp_path):
    port_telemetry.reset()
    port_profiler.reset_counters()
    port_telemetry.enable()
    try:
        with port_telemetry.span("serve.batch", kind="matmul"):
            x = htt.arange(64, dtype=htt.float32, split=0)
            htt.save_array_checkpoint(x, str(tmp_path / "ck"))
        port_telemetry.observe("sched.latency_s", 0.02)
        port_telemetry.counter_inc("unit.events", 5)
        mine = port_telemetry.report()["counters"]
        path = port_telemetry.flush(str(tmp_path / "tel"))
    finally:
        port_telemetry.disable()
    report = _script("telemetry_report")
    merged = report.merge_files([path])
    assert merged["counters"]["io.bytes_written"] == mine["io.bytes_written"] > 0
    for key, val in mine.items():
        assert merged["counters"][key] == val, key
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "telemetry_report.py"),
                          str(tmp_path / "tel"), "--json", str(tmp_path / "merged.json")],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    with open(tmp_path / "merged.json") as fh:
        assert json.load(fh)["counters"]["unit.events"] == mine["unit.events"] == 5


def test_port_flight_ring_reads_in_the_reference_postmortem(tmp_path):
    port_flightrec.enable(str(tmp_path), rank=0)
    try:
        port_flightrec.record_collective("Allreduce", 4096, torch.zeros(32, 32), 0, None)
        port_flightrec.record_event("ckpt", op="save_array", path="x")
        port_flightrec.record_collective("Allgather", 1024, torch.zeros(8, dtype=torch.bfloat16))
        port_flightrec.sync()
        pm = _script("postmortem")
        rings = pm.load_rings(str(tmp_path))
        colls = [r for r in rings[0]["records"] if r["k"] == "coll"]
        assert [(r["seq"], r["op"], r["wire"]) for r in colls] == [(1, "Allreduce", 4096), (2, "Allgather", 1024)]
        assert colls[0]["gshape"] == [32, 32] and colls[0]["dtype"] == "float32" and colls[0]["src"] == 0
        assert colls[1]["dtype"] == "bfloat16"
        verdict = pm.analyze_dir(str(tmp_path), expected_ranks=[0])
        assert verdict["verdict"] in ("clean", "inconclusive", "straggler", "desync")
    finally:
        port_flightrec.disable()


# ---------------------------------------------------------------------- #
# the serving executors at world size 1 against the reference's
# ---------------------------------------------------------------------- #
SERVE_JOBS = [("matmul", {"n": 16, "seed": 3}), ("matmul", {"n": 24, "seed": 5}), ("solve", {"n": 12}),
              ("kmeans", {"n": 64, "k": 2, "seed": 1}), ("kmeans", {"n": 101, "k": 2, "seed": 4})]


@pytest.fixture(scope="module")
def reference_results():
    ex = ref_serving.make_executor()
    out = {}
    for i, (kind, payload) in enumerate(SERVE_JOBS):
        out[i] = ex([ref_sched.Job(f"r{i}", kind, payload=payload)])[0]
    nn_jobs = [ref_sched.Job(f"n{i}", "nn_forward", payload={"features": 8, "batch": 3 + i, "seed": i})
               for i in range(3)]
    out["nn"] = ex(nn_jobs)
    return out


@pytest.mark.parametrize("i", range(len(SERVE_JOBS)), ids=[f"{k}-{p.get('n')}" for k, p in SERVE_JOBS])
def test_executor_digests_match_the_reference(reference_results, i):
    kind, payload = SERVE_JOBS[i]
    got = port_serving.make_executor()([port_sched.Job(f"p{i}", kind, payload=payload)])[0]
    want = reference_results[i]
    assert set(got) == set(want)
    np.testing.assert_allclose(got["digest"], want["digest"], rtol=SERVE_RTOL)


def test_nn_forward_stacks_the_batch_on_the_reference_parameters(reference_results):
    import jax

    import heat_tpu

    ref_model = heat_tpu.nn.Sequential(heat_tpu.nn.Linear(8, 4), heat_tpu.nn.ReLU())
    params = jax.tree_util.tree_map(np.asarray, ref_model.init(jax.random.key(0)))
    ex = port_serving.make_executor()
    htt.utils.convert.load_reference(ex._model(8), params)
    jobs = [port_sched.Job(f"n{i}", "nn_forward", payload={"features": 8, "batch": 3 + i, "seed": i})
            for i in range(3)]
    got = ex(jobs)
    assert [g["batch"] for g in got] == [3, 4, 5]
    np.testing.assert_allclose([g["digest"] for g in got], [w["digest"] for w in reference_results["nn"]],
                               rtol=SERVE_RTOL, atol=1e-6)


def test_nn_forward_parameters_come_from_a_seeded_generator():
    a, b = port_serving.make_executor()._model(16), port_serving.make_executor()._model(16)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_transport_errors_become_world_broken_and_job_errors_do_not():
    dist = torch.distributed
    for err in (dist.DistBackendError("NCCL communicator was aborted"), dist.DistNetworkError("peer gone"),
                RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection closed by peer")):
        assert port_serving._is_world_error(err), err
    for err in (RuntimeError("mat1 and mat2 shapes cannot be multiplied"), ValueError("Connection closed by peer"),
                KeyError("gloo")):
        assert not port_serving._is_world_error(err), err

    def execute_raising(exc):
        def ex(jobs):
            raise exc
        return ex

    s = port_sched.Scheduler(execute_raising(RuntimeError("shape mismatch")))
    s.submit(port_sched.Job("bad", "matmul"))
    s.run()
    assert s.outcome("bad")["state"] == "failed"


def test_dist_init_fault_site_fires_per_attempt(monkeypatch):
    from heat_tpu_torch.core import bootstrap

    calls = []
    monkeypatch.setattr(bootstrap.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(bootstrap.dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(bootstrap.dist, "broadcast", lambda t, src: t)
    port_faults.reset_trips()
    port_profiler.reset_counters()
    with port_faults.inject("dist.init", fail=2):
        bootstrap.init_distributed("tcp://localhost:1", world_size=1, rank=0, backend="gloo")
    assert port_faults.trip_count("dist.init") == 3 and len(calls) == 1
    assert port_profiler.counters()["retry.dist.init"] == 2


def test_utils_and_parallel_lack_no_public_name_of_the_reference():
    import heat_tpu

    def pub(m):
        return {n for n in dir(m) if not n.startswith("_")}

    assert pub(heat_tpu.parallel) - pub(htt.parallel) == set()
    assert pub(heat_tpu.utils) - pub(htt.utils) == set()
    for name in ("faults", "health", "telemetry", "flightrec", "memledger", "monitor", "profiler"):
        ref_mod = importlib.import_module(f"heat_tpu.utils.{name}")
        port_mod = importlib.import_module(f"heat_tpu_torch.utils.{name}")
        assert set(ref_mod.__all__) <= set(port_mod.__all__), name
