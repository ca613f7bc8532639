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
4. Holds the three flash-attention kernels against their plain versions:
   float32 and bfloat16, causal and full, d = 64 and 128, ragged S (1000,
   129) and S = 1024; each row against that row's largest value, and in
   bfloat16 the share of elements that differ at all; the forward twice to
   the same bits; d = 256 refused.
5. Trains ``TransformerLM(32768, 512, 8, depth=8, max_len=1024)`` (the
   width of the repo's LM benchmark) in float32 for 20 Adam steps on token
   batches (8, 1025) of repeated random segments: every flash kernel must
   launch 8 x 20 times and the loss must fall.  Then one step through the
   kernels against one step through their plain versions (substituted here
   with ``unittest.mock.patch``), loss and every gradient.
6. Generates 448 tokens after a (8, 64) prompt with the weights in
   bfloat16, greedily: no flash kernel may launch.  Decoding is held against
   the bfloat16 forward over the prompt, which launches the forward kernel
   once per block.
7. Times each kernel, its plain version and a library call at the main
   path's shapes and prints the ``kernels`` line.
8. Ends with the line ``{"ok": true, "device": {...}}``.

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

# H100 SXM rates (NVIDIA data sheet): float32 outside the tensor cores, bf16
# dense tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# the LM of the repo's benchmark (bench.py, lm_generate): 59 M parameters, head dim 64
LM = dict(vocab_size=32768, embed_dim=512, num_heads=8, depth=8, max_len=1024)
LM_BATCH, LM_SEQ, LM_STEPS, LM_LR = 8, 1024, 20, 1e-3
LM_SEGMENT, LM_POOL = 32, 1024  # sequences repeat a random 32-token segment drawn from 1024 tokens
PROMPT, NEW_TOKENS = 64, 448
# flash kernel checks: (batch*heads, S, d, causal)
FLASH_CHECKS = [(16, 1000, 64, True), (16, 1000, 64, False), (16, 129, 128, True), (16, 129, 128, False),
                (64, 1024, 64, True), (16, 1024, 128, False)]
FLASH_MAIN = (64, 1024, 64)  # the training step's attention: B*H = 8*8, S = 1024, d = 64, causal
FLASH_BENCH = (32, 4096, 64)  # the repo's attention benchmark shape (bench.py, flash_attention_ab), causal bf16
# kernel vs plain version, by _row_err (each row's largest error over that
# row's largest |plain|).  Both take P at the same running maximum over
# 64-key tiles and round at the same points, so they differ by float32 sum
# order: in float32 a few ulps of each term over <= 1024 keys (2e-4 on the
# gradients: row 0 of a causal dq cancels to 0 and keeps the float32
# rounding of dp - dd, ~1e-6 at d = 64, ~1e-4 of the row floor); in bfloat16
# the result rounds to bfloat16 (a step is <= 2^-7 of a value), and where
# the float32 scores differ in the last bits one P or dS may round one step
# apart too: 2^-6
FLASH_TOL = {"float32": {"out": 2e-5, "grad": 2e-4}, "bfloat16": {"out": 2.0**-6, "grad": 2.0**-6}}
ROW_FLOOR = 2.0**-7  # a row that cancels to ~0 keeps the rounding of its terms, of the tensor's or inputs' scale
# bfloat16: the share of out, dq, dk, dv elements that differ at all.  With
# P and dS rounded at the same points, a result differs only where float32
# sum order carries it across a bfloat16 rounding boundary (~1e-4 of them);
# rounding P at another maximum (the whole row's, not the running one over
# 64-key tiles) moves 5-24% of them (CPU runs of the plain version)
BF16_DIFF_SHARE = 0.01
LSE_ATOL = 2e-5  # lse is float32 in both dtypes, of magnitude ~log(S) + |s|: a few float32 ulps
# one training step through the kernels vs through the plain versions
# (float32): loss to 1e-5 relative; each parameter's gradient to 1e-3 of its
# largest entry (the attention outputs differ by float32 rounding, ~1e-6,
# and the 8 blocks' backward carries that through GEMMs and LayerNorms)
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-5, 1e-3
# bfloat16 decoding vs the bfloat16 forward: every activation rounds to
# bfloat16 (2^-8) in both, in another order (einsum + softmax against the
# flash kernel's float32 accumulation), over 8 residual blocks and the
# 32768-wide head: logits agree to 5% of their largest magnitude
DECODE_RTOL = 0.05

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


def _rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|), in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _row_err(got, want) -> float:
    """max over rows of max |got - want| / max |want| along the last axis, a
    row's scale floored at ROW_FLOOR of the tensor's largest |want| or of 1
    (the inputs' scale), whichever is larger: row 0 of a causal dq cancels
    to ~0 (one key, dS = p(dp - dd) with dd = dp)."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    scale = want.abs().amax(-1).clamp_min(ROW_FLOOR * max(float(want.abs().max()), 1.0))
    return float(((got - want).abs().amax(-1) / scale).max())


def _flash_inputs(bh, S, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((bh, S, d), generator=g, device="cuda").to(dtype) for _ in range(4)]


def check_flash_kernels() -> dict:
    """Each flash kernel against its plain version on the card; returns the
    errors at the main path's shape per dtype for the kernels line."""
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        tol = FLASH_TOL[name]
        for bh, S, d, causal in FLASH_CHECKS:
            q, k, v, do = _flash_inputs(bh, S, d, dtype, seed=S + d + causal)
            scale = d**-0.5
            out, lse = fa.flash_fwd(q, k, v, causal, scale)
            again, lse2 = fa.flash_fwd(q, k, v, causal, scale)
            torch.cuda.synchronize()
            if not (torch.equal(out, again) and torch.equal(lse, lse2)):
                fail(f"flash_fwd is not deterministic at {(bh, S, d, causal)} {name}")
            dd = (do.float() * out.float()).sum(-1)
            dq = fa.flash_bwd_dq(q, k, v, do, lse, dd, causal, scale)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, dd, causal, scale)
            out_p, lse_p = fa._torch_flash_fwd(q, k, v, causal, scale)
            dq_p = fa._torch_flash_bwd_dq(q, k, v, do, lse, dd, causal, scale)
            dk_p, dv_p = fa._torch_flash_bwd_dkv(q, k, v, do, lse, dd, causal, scale)
            torch.cuda.synchronize()
            res = {"out": _row_err(out, out_p), "dq": _row_err(dq, dq_p), "dk": _row_err(dk, dk_p),
                   "dv": _row_err(dv, dv_p)}
            lse_err = float((lse - lse_p).abs().max())
            share = {key: float((a != b).float().mean())
                     for key, a, b in (("out", out, out_p), ("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))}
            bad = {key: val for key, val in res.items() if not val <= tol["out" if key == "out" else "grad"]}
            if dtype == torch.bfloat16:
                bad.update({f"{key}_differing": val for key, val in share.items() if not val <= BF16_DIFF_SHARE})
            if bad or not lse_err <= LSE_ATOL:
                fail(f"flash kernels vs plain at {(bh, S, d, causal)} {name}: {res}, {share}, lse {lse_err}")
            abs_err = {key: float((a.float() - b.float()).abs().max())
                       for key, a, b in (("out", out, out_p), ("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))}
            print(json.dumps({"phase": "kernel_check", "kernel": "flash_fwd+flash_bwd_dq+flash_bwd_dkv", "dtype": name,
                              "bh": bh, "S": S, "d": d, "causal": causal, "max_abs_err": abs_err,
                              "lse_max_abs_err": lse_err, "row_rel_err": res, "row_rel_tol": tol,
                              "differing_share": share, "lse_atol": LSE_ATOL, "forward_repeats_bitwise": True,
                              "check": "pass"}), flush=True)
            if (bh, S, d) == FLASH_MAIN and causal:
                errs[name] = {"flash_fwd": (max(abs_err["out"], lse_err), res["out"]),
                              "flash_bwd_dq": (abs_err["dq"], res["dq"]),
                              "flash_bwd_dkv": (max(abs_err["dk"], abs_err["dv"]), max(res["dk"], res["dv"]))}
    q = torch.zeros((2, 16, 256), device="cuda")
    try:
        fa.flash_fwd(q, q, q, True, 1.0)
    except ValueError as e:
        print(json.dumps({"phase": "kernel_check", "kernel": "flash_fwd", "d": 256, "raised": str(e),
                          "check": "pass"}), flush=True)
    else:
        fail("flash_fwd took d = 256")
    return errs


def lm_batches(steps: int, seed: int):
    """Token batches (steps, B, S + 1) int64: each row repeats a random
    segment of LM_SEGMENT tokens from a pool of LM_POOL, so the next token
    is learnable (first its frequency, then by copying)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = rng.choice(LM["vocab_size"], LM_POOL, replace=False)
    seg = pool[rng.integers(0, LM_POOL, (steps, LM_BATCH, LM_SEGMENT))]
    reps = -(-(LM_SEQ + 1) // LM_SEGMENT)
    return np.tile(seg, (1, 1, reps))[:, :, : LM_SEQ + 1].astype(np.int64)


def lm_loss(ht, lm, batch):
    logits = lm(batch[:, :-1])
    return ht.nn.functional.cross_entropy(logits.reshape(-1, LM["vocab_size"]), batch[:, 1:].reshape(-1))


def lm_train(ht):
    """The training main path: 20 Adam steps at full width, counts zeroed just before."""
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    torch.manual_seed(0)
    lm = ht.nn.models.TransformerLM(**LM)
    n_params = sum(p.numel() for p in lm.parameters())
    opt = ht.optim.DataParallelOptimizer("adam", lm.parameters(), lr=LM_LR)
    batches = torch.from_numpy(lm_batches(LM_STEPS + 1, seed=11)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in fa.launch_counts:
        fa.launch_counts[key] = 0
    losses, step_s = [], []
    for step in range(LM_STEPS):
        t0 = time.perf_counter()
        loss = lm_loss(ht, lm, batches[step])
        opt.zero_grad()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
    counts = dict(fa.launch_counts)
    want = LM["depth"] * LM_STEPS
    if counts != {key: want for key in counts}:
        fail(f"LM training launches {counts}, want {want} of each flash kernel")
    if not all(x == x and abs(x) < float("inf") for x in losses) or not losses[-1] < losses[0]:
        fail(f"LM training loss did not fall: {losses}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print(json.dumps({"phase": "main_path", "path": "TransformerLM training", **LM, "params": n_params,
                      "dtype": "float32", "batch": [LM_BATCH, LM_SEQ + 1], "optimizer": "adam", "lr": LM_LR,
                      "steps": LM_STEPS, "first_step_ms": step_s[0] * 1e3, "step_ms_median": steady * 1e3,
                      "step_ms": [round(t * 1e3, 3) for t in step_s],
                      "train_tokens_per_s": LM_BATCH * LM_SEQ / steady, "first_loss": losses[0],
                      "last_loss": losses[-1], "losses": [round(x, 4) for x in losses],
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(), "guard_stats": opt.guard_stats(),
                      "launch_counts": counts}), flush=True)
    return lm, opt, counts, batches[LM_STEPS]


def _kernel_class(name: str) -> str:
    """A CUDA kernel's share of the step, by its name."""
    low = name.lower()
    if "flash_" in low:
        return "flash_attention"
    if any(word in low for word in ("gemm", "gemv", "cutlass", "xmma", "cublas", "sm90_")):
        return "gemm"
    if any(word in low for word in ("softmax", "nll", "cross_entropy")):
        return "softmax_cross_entropy"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    return "other"


def profile_device(fn, label: str) -> dict:
    """Device time by kernel class over ``fn()`` (torch.profiler), and the
    device's busy share of the wall time: kernels on one stream do not
    overlap, so their summed time is the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes, kernels = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        cls = _kernel_class(evt.key)
        classes[cls] = classes.get(cls, 0.0) + evt.self_device_time_total / 1e3  # us -> ms
        kernels += evt.count
    busy = sum(classes.values())
    if busy <= 0:
        fail(f"{label}: the profiler saw no device time")
    row = {"phase": "where_time_goes", "path": label, "wall_ms": wall * 1e3, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / (wall * 1e3), "kernel_launches": kernels,
           "device_ms_by_class": {k: round(v, 3) for k, v in sorted(classes.items(), key=lambda kv: -kv[1])}}
    print(json.dumps(row), flush=True)
    return row


def profile_training_step(ht, lm, opt, batch) -> None:
    """One training step under the profiler."""
    def step():
        loss = lm_loss(ht, lm, batch)
        opt.zero_grad()
        loss.backward()
        opt.step()

    profile_device(step, "TransformerLM training step (float32)")


def lm_step_vs_plain(ht, lm, batch) -> None:
    """One step's loss and gradients through the kernels and through their
    plain versions, substituted for the three wrappers by mock.patch."""
    from unittest import mock

    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    def step():
        lm.zero_grad(set_to_none=True)
        loss = lm_loss(ht, lm, batch)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in lm.named_parameters()}

    before = dict(fa.launch_counts)
    loss_k, grads_k = step()
    if any(fa.launch_counts[key] - before[key] != LM["depth"] for key in before):
        fail("the kernel step did not launch each flash kernel once per block")
    before = dict(fa.launch_counts)
    with mock.patch.object(fa, "flash_fwd", fa._torch_flash_fwd), \
            mock.patch.object(fa, "flash_bwd_dq", fa._torch_flash_bwd_dq), \
            mock.patch.object(fa, "flash_bwd_dkv", fa._torch_flash_bwd_dkv):
        loss_p, grads_p = step()
    if fa.launch_counts != before:
        fail("the plain step launched a kernel")
    lm.zero_grad(set_to_none=True)
    worst = max(((n, float((grads_k[n] - grads_p[n]).abs().max()) / max(float(grads_p[n].abs().max()), 1e-30))
                 for n in grads_p), key=lambda t: t[1])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(json.dumps({"phase": "one_step_vs_plain", "loss": loss_k, "plain_loss": loss_p, "loss_rel_err": loss_rel,
                      "worst_grad": worst[0], "worst_grad_rel_err": worst[1], "params_checked": len(grads_p),
                      "loss_rtol": STEP_LOSS_RTOL, "grad_rtol": STEP_GRAD_RTOL}), flush=True)
    if not loss_rel <= STEP_LOSS_RTOL or not worst[1] <= STEP_GRAD_RTOL:
        fail(f"one step through the kernels vs plain: loss {loss_rel}, gradient {worst}")


def lm_generate(ht, lm) -> None:
    """Generation in bfloat16 at bench's lm_generate shape; then decoding
    against the bfloat16 forward over the prompt."""
    import numpy as np
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    lm = lm.to(torch.bfloat16).eval()
    prompt = torch.from_numpy(np.random.default_rng(12).integers(0, LM["vocab_size"], (LM_BATCH, PROMPT))).cuda()
    for key in fa.launch_counts:
        fa.launch_counts[key] = 0
    lm.generate(prompt, NEW_TOKENS)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lm.generate(prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(fa.launch_counts)
    if any(counts.values()):
        fail(f"generation launched flash kernels: {counts}")
    if tuple(out.shape) != (LM_BATCH, PROMPT + NEW_TOKENS) or not torch.equal(out[:, :PROMPT].long(), prompt):
        fail("generate's output is not the prompt followed by the new tokens")
    if int(out.min()) < 0 or int(out.max()) >= LM["vocab_size"]:
        fail("generated tokens out of range")
    print(json.dumps({"phase": "main_path", "path": "TransformerLM generation", "dtype": "bfloat16",
                      "prompt": [LM_BATCH, PROMPT], "new_tokens": NEW_TOKENS, "greedy": True, "seconds": dt,
                      "tokens_per_s": LM_BATCH * NEW_TOKENS / dt, "launch_counts": counts}), flush=True)

    with torch.no_grad():
        caches = lm.init_caches(LM_BATCH, PROMPT)
        dec = torch.stack([lm.decode_step(prompt[:, t], t, caches)[0] for t in range(PROMPT)], dim=1)
        for key in fa.launch_counts:
            fa.launch_counts[key] = 0
        fwd = lm(prompt)
        torch.cuda.synchronize()
    if fa.launch_counts["flash_fwd"] != LM["depth"]:
        fail(f"the bfloat16 forward launched {fa.launch_counts}")
    rel = _rel_err(dec, fwd)
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    print(json.dumps({"phase": "decode_vs_forward", "dtype": "bfloat16", "positions": PROMPT,
                      "max_abs_err": float((dec.float() - fwd.float()).abs().max()),
                      "max_abs_logit": float(fwd.float().abs().max()), "rel_err": rel, "rel_tol": DECODE_RTOL,
                      "argmax_agreement": agree, "forward_launches": dict(fa.launch_counts)}), flush=True)
    if not rel <= DECODE_RTOL:
        fail(f"decode vs forward logits differ by {rel} of their largest magnitude")
    profile_device(lambda: lm.generate(prompt[:, :8], 56), "TransformerLM generation, 63 decode steps (bfloat16)")


def flash_bound(kernel: str, bh: int, S: int, d: int, itemsize: int):
    """(bound_ms, bound_by) of one causal launch: FLOP at the dtype's peak vs bytes moved once."""
    flops = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}[kernel] * bh * S * S * d / 2
    # (S, d) tensors read and written, (S,) float32 rows read and written:
    # the forward reads q, k, v and writes out, lse; dq reads q, k, v, dO,
    # lse, dd and writes dq; dk/dv the same and writes dk, dv
    t_in, r_in, t_out, r_out = {"flash_fwd": (3, 0, 1, 1), "flash_bwd_dq": (4, 2, 1, 0),
                                "flash_bwd_dkv": (4, 2, 2, 0)}[kernel]
    nbytes = (t_in + t_out) * bh * S * d * itemsize + (r_in + r_out) * bh * S * 4
    t_ops = flops / (PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_flash(bh, S, d, dtype, reps: int) -> dict:
    """ms of each kernel, its plain version and the library call, causal, at (bh, S, d)."""
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(bh, S, d, dtype, seed=5)
    scale = d**-0.5
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    dd = (do.float() * out.float()).sum(-1)
    # the library call on (B, H, S, d) views: given (B*H, S, d) it takes its math path
    q4, k4, v4, do4 = (t.view(-1, LM["num_heads"], S, d) for t in (q, k, v, do))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q4, k4, v4))
    lib_out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do4, retain_graph=True), reps)
    res = {
        "flash_fwd": (cuda_ms(lambda: fa.flash_fwd(q, k, v, True, scale), reps),
                      cuda_ms(lambda: fa._torch_flash_fwd(q, k, v, True, scale), 3),
                      cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                              reps)),
        "flash_bwd_dq": (cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, dd, True, scale), reps),
                         cuda_ms(lambda: fa._torch_flash_bwd_dq(q, k, v, do, lse, dd, True, scale), 3), lib_bwd),
        "flash_bwd_dkv": (cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, dd, True, scale), reps),
                          cuda_ms(lambda: fa._torch_flash_bwd_dkv(q, k, v, do, lse, dd, True, scale), 3), lib_bwd),
    }
    rows = {}
    for name, (ms, plain_ms, lib_ms) in res.items():
        b_ms, b_by = flash_bound(name, bh, S, d, q.element_size())
        rows[name] = {"shape": [bh, S, d], "causal": True, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib_ms}
    return rows


def flash_rows(launches: dict, errs: dict) -> list:
    """The flash kernels' rows of the kernels line: float32 at the training
    step's shape, with bfloat16 at that shape and at the attention benchmark's."""
    import torch

    f32 = time_flash(*FLASH_MAIN, torch.float32, 20)
    bf16 = time_flash(*FLASH_MAIN, torch.bfloat16, 20)
    bench = time_flash(*FLASH_BENCH, torch.bfloat16, 5)
    lines = {"flash_fwd": 132, "flash_bwd_dq": 339, "flash_bwd_dkv": 376}  # the Pallas kernel bodies
    lib = {"flash_fwd": "scaled_dot_product_attention(is_causal=True) forward",
           "flash_bwd_dq": "scaled_dot_product_attention backward: dq, dk and dv together",
           "flash_bwd_dkv": "scaled_dot_product_attention backward: dq, dk and dv together"}
    rows = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        rows.append({
            "name": name, "route": "cuda", "source": "heat_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"heat_tpu/ops/flash_attention.py:{lines[name]}", "launches": launches[name],
            "launches_per_step": launches[name] // LM_STEPS, "max_abs_err": errs["float32"][name][0],
            "row_rel_err": errs["float32"][name][1],
            **f32[name], "library_call": lib[name],
            "bfloat16": {**bf16[name], "max_abs_err": errs["bfloat16"][name][0],
                         "row_rel_err": errs["bfloat16"][name][1]},
            "bench_shape_bfloat16": bench[name], "check": "pass",
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
    flash_errs = check_flash_kernels()

    # 3. the KMeans main path at full width
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
    del xp

    # 4. the LM: training, one step against the plain versions, generation
    lm, opt, lm_launches, batch = lm_train(ht)
    profile_training_step(ht, lm, opt, batch)
    lm_step_vs_plain(ht, lm, batch)
    lm_generate(ht, lm)
    del lm, opt, batch
    torch.cuda.empty_cache()
    rows += flash_rows(lm_launches, flash_errs)

    # 5. the kernels line and the result
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
