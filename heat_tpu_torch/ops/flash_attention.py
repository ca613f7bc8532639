"""Flash attention: hand-written CUDA for Hopper, with its plain versions.

``flash_attention(q, k, v, causal=False, scale=None)`` is softmax attention
over identical ``(..., S, d)`` shapes, top-left causal (torch's
``is_causal``), output in q's dtype.  Its forward and backward run three
kernels that replace the Pallas kernels of
``heat_tpu/ops/flash_attention.py``:

- ``flash_fwd`` (``_flash_kernel``): out (BH, S, d) and the row logsumexp
  lse (BH, S) float32;
- ``flash_bwd_dq`` (``_flash_bwd_dq_kernel``): dq;
- ``flash_bwd_dkv`` (``_flash_bwd_dkv_kernel``): dk and dv.

``flash_attention_gqa(q, k, v, causal=False, scale=None)`` is grouped-query
attention: q ``(..., H_q, S, d)`` against k, v ``(..., H_kv, S, d)``, each
K/V head serving ``H_q / H_kv`` query heads.  It runs the same kernels with
K/V rows mapped per group (the reference's ``_flash_gqa_fwd_impl`` and
``_flash_gqa_bwd_impl``), so K/V are never repeated in memory, through the
wrappers ``flash_gqa_fwd``, ``flash_gqa_bwd_dq`` and ``flash_gqa_bwd_dkv``;
dk and dv sum the group's query heads in one float32 accumulator and round
once.

The CUDA source, with its C interface and its bound on the card, is
``csrc/flash_attention.cu``.  Which body runs depends on the head dim d and
the dtype, each body with its own note.  Up to d = 256 (D = 64 and 128 in
``flash_attention.cu``, D = 256 in ``flash_attention_d256.cu``) every
float32 launch runs a CUDA-core body in full float32, the forward, dq and
dk/dv of all three kinds of wrapper in ``csrc/flash_f32.cuh``; every
bfloat16 launch runs a tensor-core body (``mma.sync`` bf16 products with
float32 accumulation), the forward of ``flash_fwd``, ``flash_gqa_fwd`` and
``flash_pos_fwd`` in ``csrc/flash_fwd_tc.cuh``, dq and dk/dv in
``csrc/flash_bwd_tc.cuh``.  Past d = 256 every launch runs the wide route
(``csrc/flash_attention_wide.cu``); d has no upper cap.  Its forward
(``csrc/flash_wide.cuh``), dq and dk/dv (``csrc/flash_wide_bwd.cuh``) launch
the blocks of one tile's output column chunks as a thread block cluster
that forms each score tile once a live tile pair: each block's partial
scores over its own columns are summed through distributed shared memory
by the block that owns their rows, which, in the forward, also keeps the
rows' running max and sum and pushes P and the rescaling to every block;
bfloat16 products run on ``wgmma``, float32 on the CUDA cores.
``route(d)`` reports the unit the C dispatch runs a head dim on, from the
decision it branches on, and ``wide_plan`` how each wide kernel splits d.
A ``torch.autograd.Function`` ties them
together as the reference's ``jax.custom_vjp`` does: the forward saves
(q, k, v, out, lse), the backward computes ``dd = rowsum(dO * O)`` in torch
and launches dq and dk/dv.

A CUDA tensor launches the kernel or raises; a CPU tensor goes to the plain
version (``_torch_flash_fwd``/``_torch_flash_bwd_dq``/``_torch_flash_bwd_dkv``
and their ``_torch_flash_gqa_*`` counterparts), which the tests use and which
the kernels are held against on the card.
The plain versions keep the kernels' rounding points: P is rounded to V's
type before P.V and to dO's type before P^T.dO, dS to K's type before dS.K
and to Q's type before dS^T.Q; accumulation is float32.  The forward takes
P against the same running maximum over 64-key tiles as the kernel, so in
bfloat16 P rounds at the same values and the two differ by float32 sum
order (and, in the tensor-core forward and dq, by exp taken as 2^x on
the card's ex2: a few float32 ulps of P).  ``launch_counts`` counts kernel launches, one key a wrapper,
so a run shows which path launched.

``flash_attention_block(q, k, v, q_pos, k_pos, *, causal, scale, s_valid)``
is one attention block with explicit global positions, ring attention's
step: it returns the normalized output and the row logsumexp, which merge
exactly across blocks of disjoint keys.  Keys at positions >= ``s_valid``
never attend; under ``causal`` a query at position i attends keys at
positions <= i.  Its kernels replace the reference's positions-carrying
Pallas kernels, through the wrappers ``flash_pos_fwd`` (``_flash_pos_kernel``),
``flash_pos_bwd_dq`` (``_flash_pos_bwd_dq_kernel``) and ``flash_pos_bwd_dkv``
(``_flash_pos_bwd_dkv_kernel``): the same three CUDA bodies under a mask
that reads the positions and skips a tile whose keys are all pad or all
after its queries.  Their plain versions are ``_torch_flash_pos_*``;
``_dense_block_pos`` is the reference's dense oracle of the block.  The
backward takes the cotangents of both outputs: the lse cotangent folds
into dd = rowsum(dO * O) - g_lse.

``_dense_attention`` is the one dense softmax path of the package, for
masks, biases, rectangular shapes and attention probabilities.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_gqa", "flash_attention_block", "flash_fwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_gqa_fwd", "flash_gqa_bwd_dq", "flash_gqa_bwd_dkv", "flash_pos_fwd",
           "flash_pos_bwd_dq", "flash_pos_bwd_dkv", "launch_counts", "route", "wide_plan"]

# kernel launches since the last reset, one count per wrapper
launch_counts = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_gqa_fwd": 0, "flash_gqa_bwd_dq": 0,
                 "flash_gqa_bwd_dkv": 0, "flash_pos_fwd": 0, "flash_pos_bwd_dq": 0, "flash_pos_bwd_dkv": 0}

KEY_TILE = 64  # keys per step of the forward kernel's loop (BK in the CUDA source)
NO_MASS = -1e30  # lse of a row with no live key (_finalize's sentinel)
POS_PAD = 2**30  # the position of a pad query or key: never attends (s_valid is capped at it)


def _check(q, k, v, *qlike, grouped: bool = False, positions: bool = False) -> None:
    """Operands float32 or bfloat16, contiguous, on one device: q and the
    ``qlike`` (dO) of one shape (BHq, S, d), k and v of one shape (BHk, S, d);
    BHk = BHq, or with ``grouped`` a divisor of it.  With ``positions`` (the
    positions block) k and v may have another S than q."""
    ts = (q, k, v, *qlike)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("flash attention operands must be torch tensors")
    if (q.ndim != 3 or k.ndim != 3 or any(t.shape != q.shape for t in qlike) or k.shape != v.shape
            or k.shape[2] != q.shape[2] or not (positions or k.shape[1] == q.shape[1])
            or not (k.shape[0] == q.shape[0] or grouped and k.shape[0] and q.shape[0] % k.shape[0] == 0)):
        want = ("(BHq, S, d) q and dO, (BHk, S, d) k and v, BHk dividing BHq" if grouped else
                "(B, Sq, d) q and dO, (B, Sk, d) k and v" if positions else "one shape (BH, S, d)")
        raise ValueError(f"need operands of {want}, got {[tuple(t.shape) for t in ts]}")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"need float32 or bfloat16 operands of one dtype, got {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError(f"operands on several devices: {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash attention operands must be contiguous")
    if q.device.type == "cuda":
        if q.shape[2] < 1:
            raise ValueError(f"the CUDA flash-attention kernels take d >= 1, got d={q.shape[2]}")
    elif q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")


def _check_rows(like: torch.Tensor, *rows: torch.Tensor) -> None:
    """lse and dd: float32 (BH, S), contiguous, on the operands' device."""
    for r in rows:
        if r.shape != like.shape[:2] or r.dtype != torch.float32 or r.device != like.device or not r.is_contiguous():
            raise ValueError(f"need contiguous float32 rows {tuple(like.shape[:2])} on {like.device}, "
                             f"got {tuple(r.shape)} {r.dtype} on {r.device}")


def _check_positions(q, k, qpos, kpos, s_valid: int) -> None:
    """Positions: contiguous int32 (Sq,) and (Sk,) on the operands' device;
    0 <= s_valid < 2**31."""
    for pos, n, what in ((qpos, q.shape[1], "q_pos"), (kpos, k.shape[1], "k_pos")):
        if (not isinstance(pos, torch.Tensor) or pos.shape != (n,) or pos.dtype != torch.int32
                or pos.device != q.device or not pos.is_contiguous()):
            raise ValueError(f"{what} must be a contiguous int32 ({n},) tensor on {q.device}, got "
                             f"{getattr(pos, 'shape', None)} {getattr(pos, 'dtype', type(pos))}")
    if not 0 <= s_valid < 2**31:
        raise ValueError(f"s_valid must lie in [0, 2**31), got {s_valid}")


def _launch(name: str, plain, inputs, rows, outputs, causal: bool, scale: float, positions=(), mask=()):
    """Check the operands; send CPU tensors to ``plain``; else launch the
    kernel on q's device and current stream, raise on a nonzero code and
    count the launch under ``name``.  The grouped wrappers (``flash_gqa_*``)
    launch the kernel of their multi-head counterpart (``heat_flash_*``),
    which takes the K/V row count.  The positions wrappers (``flash_pos_*``)
    pass ``positions`` (qpos, kpos) after the rows and ``mask`` (s_valid,
    masked) after ``causal``; their kernels take (B, Sq, Sk, d) where the
    others take (BHq, BHk, S, d).  ``outputs()`` allocates the tensors the
    kernel writes."""
    _check(*inputs, grouped=name.startswith("flash_gqa_"), positions=bool(positions))
    _check_rows(inputs[0], *rows)
    if positions:
        _check_positions(inputs[0], inputs[1], *positions, mask[0])
    if inputs[0].device.type == "cpu":
        return plain(*inputs, *rows, *positions, causal, scale, *mask)
    q, k = inputs[:2]
    out = outputs()
    lib = _build.load()
    kernel = name.replace("flash_gqa_", "flash_")
    dims = (q.shape[0], q.shape[1], k.shape[1]) if positions else (q.shape[0], k.shape[0], q.shape[1])
    rc = getattr(lib, f"heat_{kernel}")(q.device.index, *(t.data_ptr() for t in (*inputs, *rows, *positions, *out)),
                                         *dims, q.shape[2], int(q.dtype == torch.bfloat16), float(scale),
                                         int(bool(causal)), *(int(x) for x in mask),
                                         torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash-attention kernel {name} failed: {lib.heat_flash_strerror(rc).decode()} (code {rc})")
    launch_counts[name] += 1
    return out if len(out) > 1 else out[0]


ROUTES = ("tiled", "d256", "wide")


def route(d: int) -> str:
    """The unit the C functions run head dim ``d`` on, as the dispatch
    decides it (``heat_flash_route``): "tiled" (the D = 64 and 128 bodies of
    ``flash_attention.cu``), "d256" (``flash_attention_d256.cu``) or "wide"
    (``flash_attention_wide.cu``).  Builds the library on first use."""
    code = _build.load().heat_flash_route(int(d))
    if code < 0:
        raise ValueError(f"the CUDA flash-attention kernels take d >= 1, got d={d}")
    return ROUTES[code]


WIDE_KERNELS = ("dq", "dkv", "fwd")  # heat_flash_wide_plan's kernel codes, in order


def wide_plan(d: int, dtype: torch.dtype, kernel: str) -> dict:
    """How the wide route's ``kernel`` ("fwd", "dq" or "dkv") splits head dim
    ``d`` (> 256) in ``dtype``, as its launcher decides it
    (``heat_flash_wide_plan``): blocks a thread block cluster, output
    columns a block, passes (clusters a tile), shared bytes a block, and the
    products at full d that the plan gives a live tile pair (the bound's: 2
    for the forward, 3 for dq, 4 for dk/dv; more where d needs passes),
    counted from the split, not by the kernels.  Builds the library on first
    use."""
    if kernel not in WIDE_KERNELS or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"need kernel 'fwd', 'dq' or 'dkv' and float32 or bfloat16, got {kernel!r}, {dtype}")
    out = (ctypes.c_int * 5)()
    rc = _build.load().heat_flash_wide_plan(int(d), int(dtype == torch.bfloat16), WIDE_KERNELS.index(kernel), out)
    if rc != 0:
        raise ValueError(f"the CUDA flash-attention kernels take d >= 1, got d={d}")
    return dict(zip(("cluster", "chunk", "passes", "smem_bytes", "plan_products_per_pair"), out))


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float):
    """(out (BH, S, d) in q's dtype, lse (BH, S) float32) of q, k, v (BH, S, d)."""
    return _launch("flash_fwd", _torch_flash_fwd, (q, k, v), (), lambda: (
        torch.empty_like(q), torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)), causal, scale)


def flash_bwd_dq(q, k, v, do, lse, dd, causal: bool, scale: float) -> torch.Tensor:
    """dq (BH, S, d) in q's dtype; ``dd`` is rowsum(dO * O) in float32."""
    return _launch("flash_bwd_dq", _torch_flash_bwd_dq, (q, k, v, do), (lse, dd), lambda: (torch.empty_like(q),),
                   causal, scale)


def flash_bwd_dkv(q, k, v, do, lse, dd, causal: bool, scale: float):
    """(dk, dv) (BH, S, d) in k's and v's dtype."""
    return _launch("flash_bwd_dkv", _torch_flash_bwd_dkv, (q, k, v, do), (lse, dd),
                   lambda: (torch.empty_like(k), torch.empty_like(v)), causal, scale)


def flash_gqa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float):
    """(out (BHq, S, d) in q's dtype, lse (BHq, S) float32) of q (BHq, S, d)
    and k, v (BHk, S, d): query row b attends K/V row b // (BHq / BHk)."""
    return _launch("flash_gqa_fwd", _torch_flash_gqa_fwd, (q, k, v), (), lambda: (
        torch.empty_like(q), torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)), causal, scale)


def flash_gqa_bwd_dq(q, k, v, do, lse, dd, causal: bool, scale: float) -> torch.Tensor:
    """dq (BHq, S, d) in q's dtype; k, v (BHk, S, d)."""
    return _launch("flash_gqa_bwd_dq", _torch_flash_gqa_bwd_dq, (q, k, v, do), (lse, dd),
                   lambda: (torch.empty_like(q),), causal, scale)


def flash_gqa_bwd_dkv(q, k, v, do, lse, dd, causal: bool, scale: float):
    """(dk, dv) (BHk, S, d) in k's and v's dtype, each summed over the
    BHq / BHk query rows of its group in float32 and rounded once."""
    return _launch("flash_gqa_bwd_dkv", _torch_flash_gqa_bwd_dkv, (q, k, v, do), (lse, dd),
                   lambda: (torch.empty_like(k), torch.empty_like(v)), causal, scale)


def flash_pos_fwd(q, k, v, qpos, kpos, causal: bool, scale: float, s_valid: int, masked: bool):
    """(out (B, Sq, d) in q's dtype, lse (B, Sq) float32) of the positions
    block: q (B, Sq, d), k, v (B, Sk, d), int32 positions qpos (Sq,) and
    kpos (Sk,); with ``masked`` a key attends where kpos < s_valid and,
    under ``causal``, qpos >= kpos.  Rows with no live key give 0 and lse
    -1e30."""
    return _launch("flash_pos_fwd", _torch_flash_pos_fwd, (q, k, v), (), lambda: (
        torch.empty_like(q), torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)),
        causal, scale, (qpos, kpos), (s_valid, masked))


def flash_pos_bwd_dq(q, k, v, do, lse, dd, qpos, kpos, causal: bool, scale: float, s_valid: int, masked: bool):
    """dq (B, Sq, d) of the positions block; ``dd`` is rowsum(dO * O) - g_lse in float32."""
    return _launch("flash_pos_bwd_dq", _torch_flash_pos_bwd_dq, (q, k, v, do), (lse, dd),
                   lambda: (torch.empty_like(q),), causal, scale, (qpos, kpos), (s_valid, masked))


def flash_pos_bwd_dkv(q, k, v, do, lse, dd, qpos, kpos, causal: bool, scale: float, s_valid: int, masked: bool):
    """(dk, dv) (B, Sk, d) of the positions block, in k's and v's dtype."""
    return _launch("flash_pos_bwd_dkv", _torch_flash_pos_bwd_dkv, (q, k, v, do), (lse, dd),
                   lambda: (torch.empty_like(k), torch.empty_like(v)), causal, scale, (qpos, kpos), (s_valid, masked))


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP (``_flash_gqa`` with
    ``grouped``): forward and backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, grouped: bool):
        out, lse = (flash_gqa_fwd if grouped else flash_fwd)(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.grouped = causal, scale, grouped
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dd = (do.float() * out.float()).sum(-1)  # D_i = sum_d dO_i * O_i, as _flash_bwd_impl leaves to XLA
        bwd_dq, bwd_dkv = (flash_gqa_bwd_dq, flash_gqa_bwd_dkv) if ctx.grouped else (flash_bwd_dq, flash_bwd_dkv)
        dq = bwd_dq(q, k, v, do, lse, dd, ctx.causal, ctx.scale)
        dk, dv = bwd_dkv(q, k, v, do, lse, dd, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention over identical ``(..., S, d)`` shapes, flash-fused on the card.

    Leading axes collapse to one batch axis.  Returns ``(..., S, d)`` in q's
    dtype; the causal mask is top-left aligned.  Differentiable: the
    backward runs the dq and dk/dv kernels."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention requires identically-shaped q/k/v, got {q.shape}, {k.shape}, {v.shape}")
    if q.ndim < 2:
        raise ValueError(f"flash_attention needs (..., S, d) operands, got {tuple(q.shape)}")
    S, d = q.shape[-2:]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    flat = [t.reshape(-1, S, d).contiguous() for t in (q, k, v)]
    return _FlashAttention.apply(*flat, bool(causal), scale, False).reshape(q.shape)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention, flash-fused on the card without repeating K/V.

    ``q``: ``(..., H_q, S, d)``; ``k``, ``v``: ``(..., H_kv, S, d)`` with
    ``H_q % H_kv == 0`` and identical leading axes; query head h attends
    K/V head ``h // (H_q / H_kv)``.  Returns ``(..., H_q, S, d)`` in q's
    dtype, with :func:`flash_attention`'s causal and masked-row semantics;
    equal head counts are :func:`flash_attention`.  Differentiable: the
    backward runs the grouped dq and dk/dv kernels."""
    if q.ndim < 3 or k.shape != v.shape or q.shape[:-3] != k.shape[:-3] or q.shape[-2:] != k.shape[-2:]:
        raise ValueError(f"flash_attention_gqa requires (..., H_q, S, d) q and (..., H_kv, S, d) k == v, "
                         f"got {q.shape}, {k.shape}, {v.shape}")
    hq, hk = q.shape[-3], k.shape[-3]
    if hq % hk:
        raise ValueError(f"query heads ({hq}) must be a multiple of key/value heads ({hk})")
    S, d = q.shape[-2:]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if hq == hk:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    flat = [t.reshape(-1, S, d).contiguous() for t in (q, k, v)]
    return _FlashAttention.apply(*flat, bool(causal), scale, True).reshape(q.shape)


class _FlashBlock(torch.autograd.Function):
    """The reference's ``_flash_pos`` custom VJP: (out, lse) forward; the
    backward takes the cotangents of both and folds the lse one into dd."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal: bool, scale: float, s_valid: int, masked: bool):
        out, lse = flash_pos_fwd(q, k, v, qpos, kpos, causal, scale, s_valid, masked)
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.args = (causal, scale, s_valid, masked)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, g_lse):
        q, k, v, qpos, kpos, out, lse = ctx.saved_tensors
        do = torch.zeros_like(out) if do is None else do.contiguous()
        # D_i = sum_d dO_i * O_i - g_lse_i: dlse/ds = p, so ds += p * g_lse is ds = p * (dp - (dd - g_lse))
        dd = (do.float() * out.float()).sum(-1)
        if g_lse is not None:
            dd = dd - g_lse.float()
        dq = flash_pos_bwd_dq(q, k, v, do, lse, dd, qpos, kpos, *ctx.args)
        dk, dv = flash_pos_bwd_dkv(q, k, v, do, lse, dd, qpos, kpos, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def _block_mask(causal: bool, s_valid: int):
    """(s_valid, masked) of a positions block: positions at or above the pad
    sentinel 2**30 never attend, even under a "no pad keys" s_valid of
    2**31 - 1, so the comparison point is capped there, and only a causal
    block or one with pad keys is masked."""
    s_valid = min(int(s_valid), POS_PAD)
    return s_valid, bool(causal) or s_valid < POS_PAD


def flash_attention_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                          k_pos: torch.Tensor, *, causal: bool, scale: float, s_valid: int):
    """One attention block with explicit global positions -> ``(out, lse)``.

    ``q``: ``(..., blk_q, d)``; ``k, v``: ``(..., blk_k, d)`` with q's
    leading axes (rectangular blocks allowed); ``q_pos``/``k_pos``: integer
    ``(blk_q,)``/``(blk_k,)`` GLOBAL positions of the rows and keys.  Keys at
    positions ``>= s_valid`` are pad and never attend; under ``causal`` a
    query at position i attends keys at positions ``<= i``.  Returns the
    normalized block output (q's dtype) and the row logsumexp (float32);
    a row with no live key gives 0 and lse -1e30.  Blocks over disjoint key
    sets merge exactly: ``lse = logaddexp(lse_a, lse_b)``,
    ``out = sum_b out_b * exp(lse_b - lse)``.  Differentiable in q, k, v,
    with the cotangents of both outputs.

    As in the reference, each side is padded to a multiple of the kernels'
    64-row tile, pad rows and keys at position 2**30, and a padded key side
    is always masked; the output is sliced back."""
    blk_q, d = q.shape[-2:]
    blk_k = k.shape[-2]
    if k.shape != v.shape or k.shape[:-2] != q.shape[:-2] or k.shape[-1] != d:
        raise ValueError(f"flash_attention_block requires k.shape == v.shape and q/k agreeing in every axis but the "
                         f"sequence, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    s_valid, masked = _block_mask(causal, s_valid)
    qf, kf, vf = (t.reshape(-1, *t.shape[-2:]) for t in (q, k, v))
    qpos = torch.as_tensor(q_pos, device=q.device).to(torch.int32)
    kpos = torch.as_tensor(k_pos, device=q.device).to(torch.int32)
    q_p, k_p = (-(-n // KEY_TILE) * KEY_TILE for n in (blk_q, blk_k))
    if q_p != blk_q:
        qf = torch.nn.functional.pad(qf, (0, 0, 0, q_p - blk_q))
        qpos = torch.nn.functional.pad(qpos, (0, q_p - blk_q), value=POS_PAD)
    if k_p != blk_k:
        kf, vf = (torch.nn.functional.pad(t, (0, 0, 0, k_p - blk_k)) for t in (kf, vf))
        kpos = torch.nn.functional.pad(kpos, (0, k_p - blk_k), value=POS_PAD)
        masked = True
    out, lse = _FlashBlock.apply(qf.contiguous(), kf.contiguous(), vf.contiguous(), qpos.contiguous(),
                                 kpos.contiguous(), bool(causal), float(scale), s_valid, masked)
    return out[:, :blk_q].reshape(q.shape), lse[:, :blk_q].reshape(q.shape[:-1])


# ---------------------------------------------------------------------- #
# plain versions of the kernels
# ---------------------------------------------------------------------- #


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """_masked_scores: float32 (BH, S, S) scores, -inf at masked keys."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        S = s.shape[-1]
        future = torch.ones((S, S), dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(future, float("-inf"))
    return s


def _scores_pos(q, k, qpos, kpos, causal: bool, scale: float, s_valid: int, masked: bool) -> torch.Tensor:
    """_masked_scores_pos: float32 (B, Sq, Sk) scores, -inf at masked keys."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if masked:
        keep = (kpos < s_valid)[None, :]
        if causal:
            keep = keep & (qpos[:, None] >= kpos[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _online_softmax(s, v, dtype):
    """The forward kernel's _online_update over its key tiles, then
    _finalize, on masked float32 scores s: (out in ``dtype``, lse).  P of
    tile t is taken against the running maximum m_t after that tile, as in
    the kernel, so it rounds to V's type at the kernel's points; the
    rescaling by exp(m_t - m_last) that the kernel applies step by step is
    applied here once, after the rounding."""
    S = s.shape[-1]
    nt = -(-S // KEY_TILE)
    tiles = torch.nn.functional.pad(s, (0, nt * KEY_TILE - S), value=float("-inf")).unflatten(-1, (nt, KEY_TILE))
    m = tiles.amax(-1).cummax(-1).values  # (BH, S, nt); -inf while no key is live
    live = torch.isfinite(m)
    safe = torch.where(live, m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(tiles), torch.exp(tiles - safe[..., None]), torch.zeros_like(tiles))
    m_last = safe[..., -1:]
    corr = torch.where(live, torch.exp(safe - m_last), torch.zeros_like(safe))
    l = (p.sum(-1) * corr).sum(-1)
    den = l.clamp_min(1e-30)
    pv = (p.to(v.dtype).float() * corr[..., None]).flatten(-2)[..., :S]
    out = torch.matmul(pv, v.float()) / den[..., None]
    lse = torch.where(l > 0, m_last[..., 0] + torch.log(den), torch.full_like(l, NO_MASS))
    return out.to(dtype), lse


def _torch_flash_fwd(q, k, v, causal: bool, scale: float):
    """Plain version of ``flash_fwd``."""
    return _online_softmax(_scores(q, k, causal, scale), v, q.dtype)


def _p_ds(s, v, do, lse, dd, scale: float):
    """_recompute_p from masked scores s, and dS = P * (dO V^T - dd) * scale, float32."""
    p = torch.where(torch.isfinite(s), torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - dd[..., None]) * scale


def _dq_of(ds, q, k) -> torch.Tensor:
    """dS K with dS rounded to K's type, in q's dtype."""
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def _dkv_of(p, ds, q, do):
    """dk = dS^T Q and dv = P^T dO in float32, dS and P rounded to Q's and dO's type."""
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk, dv


def _torch_flash_bwd_dq(q, k, v, do, lse, dd, causal: bool, scale: float) -> torch.Tensor:
    """Plain version of ``flash_bwd_dq``."""
    _, ds = _p_ds(_scores(q, k, causal, scale), v, do, lse, dd, scale)
    return _dq_of(ds, q, k)


def _torch_dkv_f32(q, k, v, do, lse, dd, causal: bool, scale: float):
    """dk and dv in float32, before the cast to k's and v's type."""
    return _dkv_of(*_p_ds(_scores(q, k, causal, scale), v, do, lse, dd, scale), q, do)


def _torch_flash_bwd_dkv(q, k, v, do, lse, dd, causal: bool, scale: float):
    """Plain version of ``flash_bwd_dkv``."""
    dk, dv = _torch_dkv_f32(q, k, v, do, lse, dd, causal, scale)
    return dk.to(k.dtype), dv.to(v.dtype)


def _torch_flash_pos_fwd(q, k, v, qpos, kpos, causal: bool, scale: float, s_valid: int, masked: bool):
    """Plain version of ``flash_pos_fwd``: the forward kernel's online
    softmax over the positions mask.  A tile the kernel skips holds only
    masked keys, so skipping it changes no running maximum."""
    return _online_softmax(_scores_pos(q, k, qpos, kpos, causal, scale, s_valid, masked), v, q.dtype)


def _torch_flash_pos_bwd_dq(q, k, v, do, lse, dd, qpos, kpos, causal: bool, scale: float, s_valid: int,
                            masked: bool) -> torch.Tensor:
    """Plain version of ``flash_pos_bwd_dq``."""
    _, ds = _p_ds(_scores_pos(q, k, qpos, kpos, causal, scale, s_valid, masked), v, do, lse, dd, scale)
    return _dq_of(ds, q, k)


def _torch_flash_pos_bwd_dkv(q, k, v, do, lse, dd, qpos, kpos, causal: bool, scale: float, s_valid: int,
                             masked: bool):
    """Plain version of ``flash_pos_bwd_dkv``."""
    s = _scores_pos(q, k, qpos, kpos, causal, scale, s_valid, masked)
    dk, dv = _dkv_of(*_p_ds(s, v, do, lse, dd, scale), q, do)
    return dk.to(k.dtype), dv.to(v.dtype)


def _repeat_groups(q, *kv):
    """K/V rows (BHk, S, d) repeated to q's BHq rows: row b // g serves query row b."""
    g = q.shape[0] // kv[0].shape[0]
    return [t.repeat_interleave(g, dim=0) for t in kv]


def _torch_flash_gqa_fwd(q, k, v, causal: bool, scale: float):
    """Plain version of ``flash_gqa_fwd``: ``_torch_flash_fwd`` over repeated K/V."""
    return _torch_flash_fwd(q, *_repeat_groups(q, k, v), causal, scale)


def _torch_flash_gqa_bwd_dq(q, k, v, do, lse, dd, causal: bool, scale: float) -> torch.Tensor:
    """Plain version of ``flash_gqa_bwd_dq``."""
    return _torch_flash_bwd_dq(q, *_repeat_groups(q, k, v), do, lse, dd, causal, scale)


def _torch_flash_gqa_bwd_dkv(q, k, v, do, lse, dd, causal: bool, scale: float):
    """Plain version of ``flash_gqa_bwd_dkv``: each query row's float32 dk,
    dv over repeated K/V, summed over the group in float32, cast once."""
    dk, dv = _torch_dkv_f32(q, *_repeat_groups(q, k, v), do, lse, dd, causal, scale)
    return tuple(t.unflatten(0, (k.shape[0], -1)).sum(1).to(k.dtype) for t in (dk, dv))


# ---------------------------------------------------------------------- #
# the dense path
# ---------------------------------------------------------------------- #


def _dense_attention(q, k, v, causal: bool, scale: float, s_valid: int, bias=None, return_probs: bool = False):
    """THE dense softmax path (reference ``_dense_attention``): every
    non-flash attention route of the package composes into it.  Keys at
    positions >= ``s_valid`` never attend; ``bias`` is an additive score bias
    broadcastable to (..., Sq, Sk) carrying user masks (bool masks converted
    to 0/-inf first).

    Fully-masked rows give 0, differentiably: the all -inf row is set to 0
    before the softmax, so no NaN reaches the backward."""
    s = torch.einsum("...qd,...kd->...qk", q, k) * scale
    Sq, Sk = s.shape[-2], s.shape[-1]
    if bias is not None:
        s = s + bias
    mask = None
    if s_valid < Sk:
        mask = (torch.arange(Sk, device=s.device) < s_valid).expand(Sq, Sk)
    if causal:
        cm = torch.arange(Sq, device=s.device)[:, None] >= torch.arange(Sk, device=s.device)[None, :]
        mask = cm if mask is None else (mask & cm)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    alive = torch.isfinite(s).any(-1, keepdim=True)
    s = torch.where(alive, s, torch.zeros_like(s))
    p = torch.softmax(s, dim=-1)
    p = torch.where(alive, p, torch.zeros_like(p))
    out = torch.einsum("...qk,...kd->...qd", p, v)
    return (out, p) if return_probs else out


def _dense_block_pos(q, k, v, q_pos, k_pos, causal: bool, scale: float, s_valid: int, masked: bool):
    """The reference's dense positions block (``_dense_block_pos``): the
    block's (out, lse) with :func:`flash_attention_block`'s mask, by plain
    autograd.  Rows with no live key give 0 and lse -1e30, the kernels'
    sentinel (the reference's docstring says log(1e-30); its code, followed
    here, writes -1e30)."""
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * scale
    if masked:
        keep = (k_pos[None, :] < s_valid).expand(s.shape[-2:])
        if causal:
            keep = keep & (q_pos[:, None] >= k_pos[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1)
    safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = p.sum(-1)
    out = torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)
    out = out / l.clamp_min(1e-30)[..., None].to(out.dtype)
    lse = torch.where(l > 0, safe + torch.log(l.clamp_min(1e-30)), torch.full_like(l, NO_MASS))
    return out.to(q.dtype), lse
