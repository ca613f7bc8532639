#!/usr/bin/env python3
"""Smoke test of heat_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Prints the card (nvidia-smi's name and power limit) and builds the CUDA
   kernels from ``heat_tpu_torch/ops/csrc``.
2. Holds each kernel against its plain PyTorch version at k=64, d=32 on a
   ragged n=1,000,003, in float32 and bfloat16.
3. Drives the main path at the BASELINE width: ``create_clusters`` with
   1e8 x 32 rows at split=0, ``KMeans(64, init="random", max_iter=20).fit``
   and ``predict``, in float32 and in bfloat16.  Each is held to one Lloyd
   step against the torch (``'jnp'``) path's from the same init, and to an
   inertia no higher than that one step's (Lloyd never raises it).  They are
   not held to recovering the generating means: a random init puts two
   centres in one blob and none in another, a local minimum that Lloyd keeps.
   So a ``kmeans++`` fit on the same 1e8 rows, and one at n = 2**22, must
   recover every generating mean.  The launch counts are zeroed just before
   each fit and read just after it.
4. Times each kernel, its plain version and the ``'jnp'`` path at the main
   path's shapes and prints the ``kernels`` line.
5. Ends with the line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result
line.  Without CUDA it exits 2 at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

K, D = 64, 32
N_MAIN = 100_000_000
N_CHECK = 1_000_003
N_EM_CHECK = 999_983  # < N_CHECK: the rows past it are pad
N_PLUSPLUS = 1 << 22
MAX_ITER = 20

# H100 SXM rates (NVIDIA data sheet): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

TIE_RTOL = 1e-5  # a label may differ where the plain top-2 gap is <= TIE_RTOL * |x|^2
D2_RTOL = 1e-5  # |d2 - plain d2| <= D2_RTOL * (|x|^2 + |c|^2): float32 rounding of the expansion
SUM_RTOL = 1e-5  # em sums vs. an exact float64 scatter of the same labels
RECOVER_TOL = 0.05  # kmeans++ fits: distance of each generating mean to its fitted centre
INERTIA_RTOL = 1e-6  # the fit's inertia may pass the one-step inertia by float64 sum rounding only


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n: int, itemsize: int, em: bool):
    """(bound_ms, bound_by): bytes moved once over HBM rate vs. float32 FMAs over peak."""
    out_bytes = (K * D + K) * 4 if em else n * 8
    nbytes = n * D * itemsize + K * D * 4 + out_bytes
    ops = 2 * n * K * D + (n * D if em else 0)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def compare_assign(x, c, lab_k, d2_k, lab_p, d2_p):
    """(mismatches, near-tie mismatches, max |d2 err|); raises past the tolerances."""
    import torch

    from heat_tpu_torch.ops import kmeans_kernels as kk

    xx = torch.linalg.vector_norm(x, dim=1, dtype=torch.float32).square()
    cc = (c * c).sum(1)
    err = (d2_k - d2_p).abs()
    scale = xx + cc[lab_p.long()]
    if bool((err > D2_RTOL * scale).any()):
        i = int((err - D2_RTOL * scale).argmax())
        fail(f"d2 row {i}: kernel {float(d2_k[i])} plain {float(d2_p[i])}")
    rows = (lab_k != lab_p).nonzero()[:, 0]
    ties = 0
    if rows.numel():
        dd = torch.cat([db for _, _, db, _ in kk.sq_dist_blocks(x[rows], c)])
        top2 = dd.topk(2, dim=1, largest=False).values
        gap = top2[:, 1] - top2[:, 0]
        far = gap > TIE_RTOL * xx[rows]
        if bool(far.any()):
            fail(f"{int(far.sum())} labels differ beyond a near tie")
        ties = int(rows.numel())
    return int(rows.numel()), ties, float(err.max())


def compare_em(x, c, n, sums_k, counts_k, lab_k, sums_p, counts_p, ties):
    """Counts exactly those of the kernel's own labels; sums against a float64
    scatter of those labels; plain version within the near-tie allowance.
    Returns (max abs error against the plain version, against the float64 scatter)."""
    import torch

    lab = lab_k[:n].long()
    want_counts = torch.bincount(lab, minlength=K).float()
    if not torch.equal(counts_k, want_counts):
        fail("em_stats counts differ from the assign kernel's labels")
    want = torch.zeros((K, D), dtype=torch.float64, device=x.device)
    mag = torch.zeros((K, D), dtype=torch.float64, device=x.device)
    for s in range(0, n, 1 << 22):
        xb = x[s : min(s + (1 << 22), n)].double()
        want.index_add_(0, lab[s : s + xb.shape[0]], xb)
        mag.index_add_(0, lab[s : s + xb.shape[0]], xb.abs())
    exact_err = (sums_k.double() - want).abs()
    if bool((exact_err > SUM_RTOL * mag + 1e-6).any()):
        fail(f"em_stats sums off by {float(exact_err.max())} from a float64 scatter")
    exact = float(exact_err.max())
    dc = float((counts_k - counts_p).abs().sum())
    if dc > 2 * ties:
        fail(f"em_stats counts differ from the plain version by {dc} beyond {ties} near ties")
    err = (sums_k - sums_p).abs()
    xmax = max(abs(float(x[:n].max())), abs(float(x[:n].min()))) if n else 0.0
    allow = SUM_RTOL * mag.float() + 2 * ties * xmax + 1e-4
    if bool((err > allow).any()):
        fail(f"em_stats sums differ from the plain version by {float(err.max())}")
    return float(err.max()), exact


def check_kernels_small(dtype) -> None:
    import torch

    from heat_tpu_torch.cluster import KMeans
    from heat_tpu_torch.ops import kmeans_kernels as kk

    g = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn((N_CHECK, D), generator=g, device="cuda") * 3.0).to(dtype)
    c = x[torch.randperm(N_CHECK, generator=g, device="cuda")[:K]].float().contiguous()
    lab_k, d2_k = kk.fused_assign(x, c)
    lab_p, d2_p = kk._torch_assign(x, c)
    torch.cuda.synchronize()
    mism, ties, d2_err = compare_assign(x, c, lab_k, d2_k, lab_p, d2_p)
    sums_k, counts_k = kk.fused_em_stats(x, c, N_EM_CHECK)
    sums_k2, counts_k2 = kk.fused_em_stats(x, c, N_EM_CHECK)
    if not (torch.equal(sums_k, sums_k2) and torch.equal(counts_k, counts_k2)):
        fail("em_stats is not deterministic")
    sums_p, counts_p = kk._torch_em_stats(x, c, N_EM_CHECK)
    tie_rows = int((lab_k[:N_EM_CHECK] != lab_p[:N_EM_CHECK]).sum())
    em_err, em_exact = compare_em(x, c, N_EM_CHECK, sums_k, counts_k, lab_k, sums_p, counts_p, tie_rows)
    name = str(dtype).replace("torch.", "")
    xl = x[:N_EM_CHECK]
    for kernel, run, plain, lib, err, extra in (
        ("assign", lambda: kk.fused_assign(x, c), lambda: kk._torch_assign(x, c),
         lambda: KMeans._assign(x, c), d2_err, {"label_mismatches": mism, "near_ties": ties}),
        ("em_stats", lambda: kk.fused_em_stats(x, c, N_EM_CHECK), lambda: kk._torch_em_stats(x, c, N_EM_CHECK),
         lambda: KMeans._blocked_stats(xl, c), em_err,
         {"count_diff": float((counts_k - counts_p).abs().sum()), "max_abs_err_vs_float64": em_exact}),
    ):
        print(json.dumps({
            "phase": "kernel_check", "kernel": kernel, "dtype": name, "n": N_CHECK, "k": K, "d": D,
            "max_abs_err": err, **extra, "ms": cuda_ms(run, 10), "plain_ms": cuda_ms(plain, 3),
            "library_ms": cuda_ms(lib, 3), "check": "pass",
        }), flush=True)


def main_fit(ht, x, label: str, init="random"):
    """One KMeans fit and predict through the public API, counts zeroed just before."""
    import torch

    from heat_tpu_torch.ops import kmeans_kernels as kk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in kk.launch_counts:
        kk.launch_counts[key] = 0
    t0 = time.perf_counter()
    km = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=MAX_ITER, random_state=0).fit(x)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    pred = km.predict(x)
    torch.cuda.synchronize()
    counts = dict(kk.launch_counts)
    centers = km.cluster_centers_.larray.float()
    if tuple(centers.shape) != (K, D) or not bool(torch.isfinite(centers).all()):
        fail(f"{label}: centres are not finite (k, d)")
    if not (km.inertia_ == km.inertia_ and km.inertia_ < float("inf")):
        fail(f"{label}: inertia is not finite")
    if counts["em_stats"] != km.n_iter_ or counts["assign"] < 2:
        fail(f"{label}: launches {counts} do not show the kernels on the path (n_iter {km.n_iter_})")
    if not torch.equal(pred.larray, km.labels_.larray):
        fail(f"{label}: predict disagrees with the fit's labels")
    labels = km.labels_.larray
    if int(labels.min()) < 0 or int(labels.max()) >= K:
        fail(f"{label}: labels out of range")
    print(json.dumps({
        "phase": "main_path", "fit": label, "n": x.shape[0], "d": D, "k": K, "dtype": str(x.dtype.__name__),
        "init": init, "n_iter": km.n_iter_, "inertia": km.inertia_, "fit_s": fit_s,
        "fit_iter_per_s": km.n_iter_ / fit_s, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launch_counts": counts,
    }), flush=True)
    return km, counts


def recovered(centers, means, tol: float) -> int:
    dist = ((means[:, None, :] - centers[None, :, :]) ** 2).sum(-1).sqrt().min(1).values
    return int((dist <= tol).sum())


def recover(ht, x, means, label: str) -> None:
    """A kmeans++ fit must put a centre within RECOVER_TOL of every generating mean."""
    kp, _ = main_fit(ht, x, label, init="kmeans++")
    got = recovered(kp.cluster_centers_.larray.float(), means, RECOVER_TOL)
    print(json.dumps({"phase": "main_path_recovery", "fit": label, "init": "kmeans++", "means_within_tol": got,
                      "tol": RECOVER_TOL, "held": True}), flush=True)
    if got != K:
        fail(f"{label}: recovered {got} of {K} generating means within {RECOVER_TOL}")


def compare_with_torch_path(ht, x, km, label: str, atol: float, rtol: float) -> None:
    """One Lloyd step from the same random init through the kernels and through
    the torch path must give the same centres and inertia, and the fit ``km``
    from that init an inertia no higher.  (Whole fits from a random init are
    not compared: where two centres split one blob, the split direction
    drifts freely and float rounding alone steers it.)"""
    fits = [
        ht.cluster.KMeans(n_clusters=K, init="random", max_iter=1, random_state=0, assign_kernel=kernel).fit(x)
        for kernel in ("pallas", "jnp")
    ]
    a, b = (f.cluster_centers_.larray.float() for f in fits)
    err = float((a - b).abs().max())
    if not bool(((a - b).abs() <= atol + rtol * b.abs()).all()):
        fail(f"{label}: one step's centres differ from the torch path's by {err}")
    if abs(fits[0].inertia_ - fits[1].inertia_) > 1e-4 * abs(fits[1].inertia_):
        fail(f"{label}: inertia {fits[0].inertia_} vs torch path {fits[1].inertia_}")
    if km.inertia_ > fits[0].inertia_ * (1.0 + INERTIA_RTOL):
        fail(f"{label}: {km.n_iter_} steps end at inertia {km.inertia_}, above one step's {fits[0].inertia_}")
    print(json.dumps({"phase": "one_step_vs_torch_path", "fit": label, "max_abs_centre_err": err,
                      "inertia": fits[0].inertia_, "torch_path_inertia": fits[1].inertia_,
                      "fit_inertia": km.inertia_,
                      "atol": atol, "rtol": rtol}), flush=True)


def check_at_main_shape(x, c, label: str):
    """Both kernels against their plain versions on the main path's data and
    fitted centres; returns each kernel's max abs error."""
    from heat_tpu_torch.ops import kmeans_kernels as kk

    n = x.shape[0]
    lab_k, d2_k = kk.fused_assign(x, c)
    lab_p, d2_p = kk._torch_assign(x, c)
    mism, ties, d2_err = compare_assign(x, c, lab_k, d2_k, lab_p, d2_p)
    sums_k, counts_k = kk.fused_em_stats(x, c)
    sums_p, counts_p = kk._torch_em_stats(x, c, n)
    em_err, em_exact = compare_em(x, c, n, sums_k, counts_k, lab_k, sums_p, counts_p, ties)
    print(json.dumps({"phase": "kernel_check_main_shape", "dtype": label, "n": n, "label_mismatches": mism,
                      "near_ties": ties, "assign_max_abs_err": d2_err, "em_stats_max_abs_err": em_err,
                      "em_stats_max_abs_err_vs_float64": em_exact,
                      "count_diff": float((counts_k - counts_p).abs().sum()), "check": "pass"}), flush=True)
    return {"assign": (d2_err, None), "em_stats": (em_err, em_exact)}


def time_kernels(x, c, launches, err):
    """Kernel, plain and torch-path times at the main path's shapes; one entry per kernel."""
    from heat_tpu_torch.cluster import KMeans
    from heat_tpu_torch.ops import kmeans_kernels as kk

    n, itemsize = x.shape[0], x.element_size()
    rows = []
    for name, run, plain, lib, em, line in (
        ("assign", lambda: kk.fused_assign(x, c), lambda: kk._torch_assign(x, c),
         lambda: KMeans._assign(x, c), False, 67),
        ("em_stats", lambda: kk.fused_em_stats(x, c), lambda: kk._torch_em_stats(x, c, n),
         lambda: KMeans._blocked_stats(x, c), True, 111),
    ):
        b_ms, b_by = bound(n, itemsize, em)
        rows.append({
            "name": name, "route": "cuda", "source": "heat_tpu_torch/ops/csrc/kmeans.cu",
            "replaces": f"heat_tpu/ops/kmeans_kernels.py:{line}", "launches": launches[name],
            "max_abs_err": err[name][0], "max_abs_err_vs_float64": err[name][1],
            "ms": cuda_ms(run, 5), "plain_ms": cuda_ms(plain, 2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib, 2), "check": "pass",
        })
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU", file=sys.stderr)
        return 2
    import heat_tpu_torch as ht
    from heat_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    ht.use_device("gpu")

    # 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": name}), flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "library": _build.build_info["library"]}), flush=True)
    for line in _build.build_info["log"].splitlines():
        if any(word in line for word in ("entry function", "registers", "spill", "error")):
            print("ptxas:", line.strip())

    # 2. kernels against their plain versions
    for dtype in (torch.float32, torch.bfloat16):
        check_kernels_small(dtype)

    # 3. the main path at full width
    gm = torch.Generator().manual_seed(7)
    means = torch.rand((K, D), generator=gm) * 40.0 - 20.0
    x = ht.utils.data.create_clusters(N_MAIN, D, K, means.numpy(), cluster_std=1.0, device="gpu", random_state=0)
    km, launches = main_fit(ht, x, "float32")
    means_dev = means.cuda()
    print(json.dumps({"phase": "main_path_recovery", "fit": "float32", "init": "random",
                      "means_within_tol": recovered(km.cluster_centers_.larray.float(), means_dev, RECOVER_TOL),
                      "tol": RECOVER_TOL, "held": False}), flush=True)
    # near-tie rows, where the two paths' float32 expansions round apart,
    # move a centre by ~1e-3 in one step at this size
    compare_with_torch_path(ht, x, km, "float32", atol=2e-2, rtol=1e-4)
    recover(ht, x, means_dev, "float32_kmeans++")

    rows = time_kernels(x.larray, km._centers, launches, check_at_main_shape(x.larray, km._centers, "float32"))

    xb = ht.utils.data.create_clusters(N_MAIN, D, K, means.numpy(), cluster_std=1.0, device="gpu",
                                       random_state=0, dtype=ht.bfloat16)
    del x
    kb, launches_bf16 = main_fit(ht, xb, "bfloat16")
    compare_with_torch_path(ht, xb, kb, "bfloat16", atol=2e-2, rtol=2.0**-7)  # plus one bfloat16 ulp
    errs = check_at_main_shape(xb.larray, kb._centers, "bfloat16")
    for row, bf in zip(rows, time_kernels(xb.larray, kb._centers, launches_bf16, errs)):
        row["bfloat16"] = {key: bf[key] for key in ("launches", "max_abs_err", "max_abs_err_vs_float64", "ms",
                                                     "plain_ms", "bound_ms", "bound_by", "library_ms", "check")}
    del xb

    xp = ht.utils.data.create_clusters(N_PLUSPLUS, D, K, means.numpy(), cluster_std=1.0, device="gpu",
                                       random_state=1)
    recover(ht, xp, means_dev, "float32_kmeans++_2^22")

    # 4. the kernels line, 5. the result
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
