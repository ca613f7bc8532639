"""KMeans E-step kernels: hand-written CUDA for Hopper, with their plain versions.

``fused_assign(x, centers)`` gives each row's label and clamped min d²;
``fused_em_stats(x, centers, n)`` gives the per-cluster sums (k, d) and
counts (k,) of one Lloyd sweep over rows ``[0, n)``.  They replace the
Pallas kernels ``_assign_kernel`` and ``_em_stats_kernel`` of
``heat_tpu/ops/kmeans_kernels.py``; the CUDA source, with its design and
its bound on the card, is ``csrc/kmeans.cu``.  Both take x.c on the tensor
cores as split-TF32 products (x and c each a sum of two TF32 parts, three
products in float32, two for bfloat16 x, which TF32 holds exactly: about
2^-21 of |x||c|, against 2^-11 for one TF32 product), on 32-row tiles that
an asynchronous copy ring brings into shared memory.  ``em_stats`` runs
``assign``'s distance pass, so its labels are ``assign``'s to the bit, then
sums each run of rows of one label in registers and adds it to its
cluster once; each block's partial sums are added in block order in
float64 by a second kernel, into scratch this wrapper allocates.

A CUDA tensor launches the kernel or raises; a CPU tensor goes to the plain
version (``_torch_assign``/``_torch_em_stats``), which the tests use and
which the kernels are held against on the card.  Both compute
``d² = (‖x‖² + ‖c‖²) − 2x·c`` in float32, clamp it at 0 and then take the
argmin, lowest index first; the plain versions take x·c in full float32.
``launch_counts`` counts kernel launches; ``launch_config`` reports the
launch the library picks (warps a block, ring stages, and the resident
warps an SM that the CUDA runtime's occupancy calculator gives it);
``resident_warps`` observes the warps resident on each SM while a call runs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_assign", "fused_em_stats", "launch_config", "launch_counts", "resident_warps",
           "sq_dist_blocks"]

# kernel launches since the last reset, one count per kernel
launch_counts = {"assign": 0, "em_stats": 0}

MAX_D = 128  # row tiles and centres are padded to 32, 64 or 128 columns
BLOCK = 1 << 20  # rows per step of the torch paths: bounds their (rows, k) temporaries


def sq_dist_blocks(x: torch.Tensor, centers: torch.Tensor, clamp_first: bool = True, stop=None):
    """The torch paths' E-step, over row blocks of ``x[:stop]``: never an
    (n, k) or (n, k, d) tensor.  Yields ``(start, xb, d2, labels)``: the block
    in float32, its squared distances (rows, k) to ``centers`` by the float32
    expansion ``(‖x‖² + ‖c‖²) − 2x·c`` clamped at 0, and each row's argmin
    (lowest index first), taken after the clamp as the kernels do or, with
    ``clamp_first=False``, before it as the reference's ``_assign`` does."""
    c = centers.float()
    cc = (c * c).sum(1)[None, :]
    stop = x.shape[0] if stop is None else stop
    for s in range(0, stop, BLOCK):
        xb = x[s : min(s + BLOCK, stop)].float()
        db = ((xb * xb).sum(1, keepdim=True) + cc) - 2.0 * (xb @ c.T)
        if clamp_first:
            db.clamp_min_(0.0)
        lb = db.argmin(1)
        yield s, xb, db.clamp_min_(0.0), lb


def _check(x: torch.Tensor, centers: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor) or not isinstance(centers, torch.Tensor):
        raise TypeError("x and centers must be torch tensors")
    if x.ndim != 2 or centers.ndim != 2 or centers.shape[1] != x.shape[1]:
        raise ValueError(f"need x (n, d) and centers (k, d), got {tuple(x.shape)} and {tuple(centers.shape)}")
    if centers.shape[0] < 1:
        raise ValueError("need at least one center")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if centers.dtype != torch.float32:
        raise TypeError(f"centers must be float32, got {centers.dtype}")
    if x.device != centers.device:
        raise ValueError(f"x is on {x.device} but centers on {centers.device}")
    if not (x.is_contiguous() and centers.is_contiguous()):
        raise ValueError("x and centers must be contiguous")
    if x.device.type == "cuda":
        # k * d past the shared-memory layout is refused by the library itself
        if centers.shape[1] > MAX_D:
            raise ValueError(f"the CUDA kernels take d <= {MAX_D}, got d={centers.shape[1]}")
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"kmeans {what} kernel failed: {lib.heat_kmeans_strerror(rc).decode()} (code {rc})")


def fused_assign(x: torch.Tensor, centers: torch.Tensor):
    """(labels int32 (n,), min d² float32 (n,)) of each row of ``x`` against ``centers``."""
    _check(x, centers)
    if x.device.type == "cpu":
        return _torch_assign(x, centers)
    n, d = x.shape
    k = centers.shape[0]
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return labels, d2
    lib = _build.load()
    rc = lib.heat_kmeans_assign(
        x.device.index, x.data_ptr(), centers.data_ptr(), n, k, d, int(x.dtype == torch.bfloat16),
        labels.data_ptr(), d2.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(lib, rc, "assign")
    launch_counts["assign"] += 1
    return labels, d2


def fused_em_stats(x: torch.Tensor, centers: torch.Tensor, n=None):
    """(sums float32 (k, d), counts float32 (k,)) of one assign-and-accumulate
    sweep; rows at index ≥ ``n`` (default: all rows) contribute nothing.

    Deterministic on the card: the same inputs give the same bits."""
    _check(x, centers)
    rows, d = x.shape
    n = rows if n is None else min(max(int(n), 0), rows)
    if x.device.type == "cpu":
        return _torch_em_stats(x, centers, n)
    k = centers.shape[0]
    bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.load()
    grid = lib.heat_kmeans_em_grid(x.device.index, n, k, d, bf16)
    if grid < 0:
        _raise_on(lib, grid, "em_stats")
    psums = torch.empty((grid, k, d), dtype=torch.float32, device=x.device)
    pcounts = torch.empty((grid, k), dtype=torch.int32, device=x.device)
    sums = torch.empty((k, d), dtype=torch.float32, device=x.device)
    counts = torch.empty(k, dtype=torch.float32, device=x.device)
    rc = lib.heat_kmeans_em_stats(
        x.device.index, x.data_ptr(), centers.data_ptr(), n, k, d, bf16, grid,
        psums.data_ptr(), pcounts.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(lib, rc, "em_stats")
    launch_counts["em_stats"] += 1
    return sums, counts


def launch_config(k: int, d: int, dtype=torch.float32, em: bool = False) -> dict:
    """The launch ``fused_assign`` (or, with ``em``, ``fused_em_stats``)
    makes on the current card for ``k`` centres of width ``d``: the
    tensor-core instruction of its products (``wgmma`` where the centres'
    TF32 parts fit in shared memory, else ``mma.sync``), warps a block, row
    tiles in each warp's copy ring, blocks and warps resident on an SM (the
    CUDA runtime's occupancy calculator) and shared bytes a block."""
    lib = _build.load()
    out = (ctypes.c_int * 5)()
    rc = lib.heat_kmeans_launch_config(torch.cuda.current_device(), k, d, int(dtype == torch.bfloat16), int(em), out)
    _raise_on(lib, rc, "em_stats" if em else "assign")
    wg, warps, stages, blocks, smem = out
    return {"products": "wgmma" if wg else "mma.sync", "warps": warps, "stages": stages, "blocks_per_sm": blocks,
            "resident_warps": blocks * warps, "smem_bytes": smem}


def resident_warps(run) -> list:
    """The most warps of ``assign`` and ``em_stats`` live at once on each SM
    while ``run()`` launches them on the current card, one entry for each SM
    that held any: each warp counts itself on its SM (``kmeans.cu``'s
    residency counter, on only during this call)."""
    lib = _build.load()
    device = torch.cuda.current_device()
    peak = (ctypes.c_int * 1024)()
    _raise_on(lib, lib.heat_kmeans_residency(device, 1, peak, len(peak)), "residency")
    try:
        run()
    finally:
        rc = lib.heat_kmeans_residency(device, 0, peak, len(peak))
    _raise_on(lib, rc, "residency")
    return [v for v in peak if v > 0]


def _torch_assign(x: torch.Tensor, centers: torch.Tensor):
    """Plain version of ``fused_assign`` (counterpart of ``_jnp_assign``)."""
    n = x.shape[0]
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    for s, _, db, lb in sq_dist_blocks(x, centers):
        labels[s : s + lb.shape[0]] = lb.int()
        d2[s : s + lb.shape[0]] = db.gather(1, lb[:, None])[:, 0]
    return labels, d2


def _torch_em_stats(x: torch.Tensor, centers: torch.Tensor, n: int):
    """Plain version of ``fused_em_stats`` (counterpart of ``_jnp_em_stats``):
    the labels of ``sq_dist_blocks``, then each block's one-hot GEMM, added up
    in float64.

    Not ``index_add_``: its float32 running sums of a big cluster round every
    add at the sum's magnitude, and on rows of nearly equal values that
    rounding is biased, so the sums of a cluster of millions of rows drift."""
    k, d = centers.shape
    sums = torch.zeros((k, d), dtype=torch.float64, device=x.device)
    counts = torch.zeros(k, dtype=torch.int64, device=x.device)
    ids = torch.arange(k, device=x.device)
    for _, xb, _, lb in sq_dist_blocks(x, centers, stop=n):
        sums += (lb[None, :] == ids[:, None]).float() @ xb
        counts += torch.bincount(lb, minlength=k)
    return sums.float(), counts.float()
