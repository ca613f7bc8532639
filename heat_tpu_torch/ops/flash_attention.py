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

The CUDA source, with its design and its bound on the card, is
``csrc/flash_attention.cu``.  A ``torch.autograd.Function`` ties them
together as the reference's ``jax.custom_vjp`` does: the forward saves
(q, k, v, out, lse), the backward computes ``dd = rowsum(dO * O)`` in torch
and launches dq and dk/dv.

A CUDA tensor launches the kernel or raises; a CPU tensor goes to the plain
version (``_torch_flash_fwd``/``_torch_flash_bwd_dq``/``_torch_flash_bwd_dkv``),
which the tests use and which the kernels are held against on the card.
The plain versions keep the kernels' rounding points: P is rounded to V's
type before P.V and to dO's type before P^T.dO, dS to K's type before dS.K
and to Q's type before dS^T.Q; accumulation is float32.  The forward takes
P against the same running maximum over 64-key tiles as the kernel, so in
bfloat16 P rounds at the same values and the two differ by float32 sum
order only.  ``launch_counts`` counts kernel launches.

``_dense_attention`` is the one dense softmax path of the package, for
masks, biases, rectangular shapes and attention probabilities.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "launch_counts"]

# kernel launches since the last reset, one count per kernel
launch_counts = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

MAX_D = 128  # tiles are zero-padded to 64 or 128 columns
KEY_TILE = 64  # keys per step of the forward kernel's loop (BK in the CUDA source)
NO_MASS = -1e30  # lse of a row with no live key (_finalize's sentinel)


def _check(*ts: torch.Tensor) -> None:
    """Operands (BH, S, d) of one shape, float32 or bfloat16, contiguous, on one device."""
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("flash attention operands must be torch tensors")
    first = ts[0]
    if first.ndim != 3 or any(t.shape != first.shape for t in ts):
        raise ValueError(f"need operands of one shape (BH, S, d), got {[tuple(t.shape) for t in ts]}")
    if first.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != first.dtype for t in ts):
        raise TypeError(f"need float32 or bfloat16 operands of one dtype, got {[t.dtype for t in ts]}")
    if any(t.device != first.device for t in ts):
        raise ValueError(f"operands on several devices: {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash attention operands must be contiguous")
    if first.device.type == "cuda":
        if not 1 <= first.shape[2] <= MAX_D:
            raise ValueError(f"the CUDA flash-attention kernels take 1 <= d <= {MAX_D}, got d={first.shape[2]}")
    elif first.device.type != "cpu":
        raise ValueError(f"unsupported device {first.device}")


def _check_rows(like: torch.Tensor, *rows: torch.Tensor) -> None:
    """lse and dd: float32 (BH, S), contiguous, on the operands' device."""
    for r in rows:
        if r.shape != like.shape[:2] or r.dtype != torch.float32 or r.device != like.device or not r.is_contiguous():
            raise ValueError(f"need contiguous float32 rows {tuple(like.shape[:2])} on {like.device}, "
                             f"got {tuple(r.shape)} {r.dtype} on {r.device}")


def _launch(name: str, plain, inputs, rows, outputs, causal: bool, scale: float):
    """Check the operands; send CPU tensors to ``plain``; else launch the
    kernel ``heat_<name>`` on q's device and current stream, raise on a
    nonzero code and count the launch.  ``outputs()`` allocates the
    tensors the kernel writes."""
    _check(*inputs)
    _check_rows(inputs[0], *rows)
    if inputs[0].device.type == "cpu":
        return plain(*inputs, *rows, causal, scale)
    q = inputs[0]
    out = outputs()
    lib = _build.load()
    bh, s, d = q.shape
    rc = getattr(lib, f"heat_{name}")(q.device.index, *(t.data_ptr() for t in (*inputs, *rows, *out)), bh, s, d,
                                       int(q.dtype == torch.bfloat16), float(scale), int(bool(causal)),
                                       torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash-attention kernel {name} failed: {lib.heat_flash_strerror(rc).decode()} (code {rc})")
    launch_counts[name] += 1
    return out if len(out) > 1 else out[0]


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


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward and backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dd = (do.float() * out.float()).sum(-1)  # D_i = sum_d dO_i * O_i, as _flash_bwd_impl leaves to XLA
        dq = flash_bwd_dq(q, k, v, do, lse, dd, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, dd, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


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
    return _FlashAttention.apply(*flat, bool(causal), scale).reshape(q.shape)


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


def _torch_flash_fwd(q, k, v, causal: bool, scale: float):
    """Plain version of ``flash_fwd``: _online_update over the kernel's key
    tiles, then _finalize.  P of tile t is taken against the running maximum
    m_t after that tile, as in the kernel, so it rounds to V's type at the
    kernel's points; the rescaling by exp(m_t - m_last) that the kernel
    applies step by step is applied here once, after the rounding."""
    s = _scores(q, k, causal, scale)
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
    return out.to(q.dtype), lse


def _torch_p_ds(q, k, v, do, lse, dd, causal: bool, scale: float):
    """_recompute_p and dS = P * (dO V^T - dd) * scale, float32."""
    s = _scores(q, k, causal, scale)
    p = torch.where(torch.isfinite(s), torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - dd[..., None]) * scale


def _torch_flash_bwd_dq(q, k, v, do, lse, dd, causal: bool, scale: float) -> torch.Tensor:
    """Plain version of ``flash_bwd_dq``."""
    _, ds = _torch_p_ds(q, k, v, do, lse, dd, causal, scale)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def _torch_flash_bwd_dkv(q, k, v, do, lse, dd, causal: bool, scale: float):
    """Plain version of ``flash_bwd_dkv``."""
    p, ds = _torch_p_ds(q, k, v, do, lse, dd, causal, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float()).to(v.dtype)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()).to(k.dtype)
    return dk, dv


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
