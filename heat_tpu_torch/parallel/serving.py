"""Job executors for the elastic scheduler (the serving tier), on the port.

``scheduler.py`` is deliberately stdlib-only: it knows nothing about
tensors or collectives.  This module is its runtime half (the reference's
``parallel/serving.py``): executors for the heterogeneous job kinds of the
serving scenario, **KMeans fits**, **matmul / triangular-solve requests**
and **NN forward batches**, each built deterministically from the job's
JSON payload, so every rank of an SPMD world reconstructs the identical
computation and issues the identical collectives.

Micro-batching contract: :func:`batch_key` groups jobs by *program
signature* (kind + structural payload fields, data/seed fields excluded),
so same-shape requests from different tenants share one dispatch;
``nn_forward`` batches stack into a single forward pass.

Deadline contract: the scheduler arms ``health.deadline`` around every
dispatch, so the collectives inside these executors refuse to start, and
the guarded blocking waits trip ``CollectiveTimeoutError``, at the
offending job when the world wedges.

A transport failure of ``torch.distributed`` under a dispatch (a peer died:
``DistBackendError``, ``DistNetworkError``, gloo's connection-closed
errors) becomes :class:`scheduler.WorldBroken`, so the batch is requeued
instead of failed; a job's own error is never mapped that way.

All torch imports are lazy (inside :func:`make_executor`): importing this
module costs nothing, and ``heat_tpu_torch.parallel`` stays importable in
processes that never execute a job.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List

from . import scheduler as _scheduler

__all__ = ["KINDS", "batch_key", "make_executor"]

# torch.distributed's transport errors, by class name (DistNetworkError
# subclasses DistError; DistBackendError is what NCCL and gloo raise when a
# peer's connection goes away)
_WORLD_ERROR_TYPES = ("DistBackendError", "DistNetworkError", "DistStoreError")
# gloo reports a dead peer as a plain RuntimeError whose message names the
# transport: matched only on these, never on a job's own RuntimeError
_GLOO_TRANSPORT_MESSAGES = ("Connection closed by peer", "Connection reset by peer", "Broken pipe",
                            "[enforce fail at ../third_party/gloo", "gloo/transport")


def _is_world_error(e: BaseException) -> bool:
    """True when ``e`` is the distributed machinery failing (a peer's
    connection went away), by type or by gloo's transport message."""
    if any(k.__name__ in _WORLD_ERROR_TYPES for k in type(e).__mro__):
        return True
    if type(e) is RuntimeError:
        text = str(e)
        return any(m in text for m in _GLOO_TRANSPORT_MESSAGES)
    return False


def _raise_world_broken(e: BaseException):
    """Convert a transport failure into :class:`scheduler.WorldBroken` so
    the scheduler requeues the batch instead of terminally failing jobs
    whose only crime was running while a peer died."""
    if _is_world_error(e):
        raise _scheduler.WorldBroken(f"distributed runtime failed under dispatch: {e}") from e


KINDS = ("matmul", "solve", "kmeans", "nn_forward")

# payload fields that parameterize the DATA, not the program: excluded from
# the batch signature so same-shape jobs share one dispatch
_DATA_FIELDS = ("seed",)


def batch_key(job) -> str:
    """Program-signature batch key: jobs whose payloads differ only in
    data fields (``seed``) are compatible, one shared SPMD dispatch."""
    sig = {k: v for k, v in job.payload.items() if k not in _DATA_FIELDS}
    return f"{job.kind}|{json.dumps(sig, sort_keys=True)}"


def make_executor(comm=None) -> Callable[[List[Any]], List[Any]]:
    """Build the ``executor(jobs) -> results`` callable for
    :class:`heat_tpu_torch.parallel.scheduler.Scheduler`, on the default
    device (the card where there is one).

    Every result is ``{"digest": float, ...}``: a host-materialized scalar
    summary, so a DONE job is attested by a value that actually crossed the
    device-to-host boundary.  ``matmul`` and ``solve`` build their operands
    from ``arange``/``tril``/``eye`` split 0 and digest the sum of the
    product or the solution; ``kmeans`` fits two blobs of ``n`` 2-D points
    (a CUDA tensor takes the KMeans kernels) and digests the sum of the
    centres, which does not depend on their order; ``nn_forward`` stacks
    the batch's inputs into one forward of ``Sequential(Linear(features,
    4), ReLU())``, whose parameters come from a ``torch.Generator`` seeded
    with 0, identical on every rank.  The returned callable's ``_model(f)``
    gives that module for width ``f`` (``utils.convert.load_reference`` can
    load the reference's parameters into it)."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht

    if comm is None:
        comm = ht.communication.get_comm()

    _models: Dict[int, torch.nn.Module] = {}

    def _model(features: int) -> torch.nn.Module:
        got = _models.get(features)
        if got is None:
            got = ht.nn.Sequential(ht.nn.Linear(features, 4), ht.nn.ReLU())
            g = torch.Generator().manual_seed(0)
            bound = features ** -0.5  # torch.nn.Linear's own init range, from the seeded generator
            with torch.no_grad():
                for p in got.parameters():
                    p.copy_((torch.rand(p.shape, generator=g) * 2.0 - 1.0) * bound)
            got.eval()
            _models[features] = got
        return got

    def _digest(x) -> float:
        """Host digest of a DNDarray's sum (the one device-to-host read a job)."""
        return float(x.sum().item())

    def _matmul(job) -> dict:
        n = int(job.payload.get("n", 16))
        scale = 1.0 + int(job.payload.get("seed", 0)) % 7
        a = ht.reshape(ht.arange(n * n, dtype=ht.float32, split=0, comm=comm), (n, n))
        a = a * (scale / n)
        c = a @ ht.transpose(a)
        return {"digest": _digest(c), "n": n}

    def _solve(job) -> dict:
        n = int(job.payload.get("n", 8))
        # a well-conditioned lower-triangular system, deterministic entries
        ln = ht.reshape(ht.arange(n * n, dtype=ht.float32, split=0, comm=comm), (n, n))
        a = ht.tril(ln * (1.0 / (n * n))) + ht.eye(n, dtype=ht.float32, split=0, comm=comm) * 2.0
        b = ht.reshape(ht.arange(n, dtype=ht.float32, split=0, comm=comm), (n, 1))
        x = ht.linalg.solve_triangular(a, b, lower=True)
        return {"digest": _digest(x), "n": n}

    def _kmeans(job) -> dict:
        n = int(job.payload.get("n", 32))
        k = int(job.payload.get("k", 2))
        # payload-seeded: every rank draws the identical stream
        rng = np.random.default_rng(int(job.payload.get("seed", 0)))
        pts = rng.standard_normal((n, 2)).astype(np.float32)
        pts[: n // 2] += 8.0  # two separable blobs: the fit converges fast
        x = ht.utils.convert.array_from_numpy(pts, 0, comm=comm)
        km = ht.cluster.KMeans(n_clusters=k, init="random", max_iter=5, random_state=0)
        km.fit(x)
        return {"digest": _digest(km.cluster_centers_), "k": k}

    def _nn_forward_batch(jobs) -> List[dict]:
        """The stacked kind: all jobs' inputs concatenate into ONE forward
        pass, results split back per job."""
        features = int(jobs[0].payload.get("features", 8))
        model = _model(features)
        xs, sizes = [], []
        for job in jobs:
            b = int(job.payload.get("batch", 4))
            rng = np.random.default_rng(int(job.payload.get("seed", 0)))
            xs.append(rng.standard_normal((b, features)).astype(np.float32))
            sizes.append(b)
        dev = next(model.parameters()).device
        with torch.no_grad():
            out = model(torch.from_numpy(np.concatenate(xs, axis=0)).to(dev))
        sums = out.sum(1).double().cpu()
        results, off = [], 0
        for b in sizes:
            results.append({"digest": float(sums[off: off + b].sum()), "batch": b})
            off += b
        return results

    _single = {"matmul": _matmul, "solve": _solve, "kmeans": _kmeans}

    # federation admission feedback: with HEAT_TPU_FED_PEAKS set to a
    # history path and the memory ledger armed, every executed batch is
    # bracketed in a memledger.peak_window (on a card, the allocator's
    # peak) and its incremental peak is recorded per kind, the persisted
    # history federation.AdmissionPredictor sheds mem_infeasible jobs
    # against at the edge
    _predictor = None
    _peaks_path = os.environ.get("HEAT_TPU_FED_PEAKS")
    if _peaks_path:
        from ..utils import memledger as _memledger

        if _memledger.enabled():
            from . import federation as _federation

            _predictor = _federation.AdmissionPredictor(_peaks_path)

    def _run(jobs: List[Any]) -> List[Any]:
        kind = jobs[0].kind
        if kind == "nn_forward":
            return _nn_forward_batch(jobs)
        fn = _single.get(kind)
        if fn is None:
            raise ValueError(f"unknown job kind {kind!r} (serve {KINDS})")
        return [fn(job) for job in jobs]

    def execute(jobs: List[Any]) -> List[Any]:
        try:
            if _predictor is not None:
                from ..utils import memledger as _memledger

                with _memledger.peak_window() as w:
                    results = _run(jobs)
                # per-JOB footprint: the batch's incremental peak split
                # evenly (the window's maximum already over-counts
                # concurrent neighbours)
                delta = max(0, int(w["peak"]) - int(w["base"]))
                if delta > 0:
                    _predictor.observe(jobs[0].kind, (delta + len(jobs) - 1) // len(jobs))
                return results
            return _run(jobs)
        except Exception as e:
            _raise_world_broken(e)  # transport death -> WorldBroken
            raise

    execute._model = _model
    return execute
