// Flash attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of heat_tpu/ops/flash_attention.py:
//   flash_fwd     <- _flash_kernel (l.132) via _flash_fwd_impl (l.479), with
//                    _masked_scores (l.167), _online_update (l.94) and
//                    _finalize (l.117): O (B*H, S, d) in q's type and the
//                    row logsumexp lse (B*H, S) float32
//   flash_bwd_dq  <- _flash_bwd_dq_kernel (l.339) via _flash_bwd_impl (l.517)
//   flash_bwd_dkv <- _flash_bwd_dkv_kernel (l.376), also via _flash_bwd_impl
// Both backward kernels recompute p = exp(s - lse) as _recompute_p (l.185)
// does; dd = rowsum(dO * O) is computed by the caller (l.523 leaves it to
// XLA, the wrapper to torch).
//
// The positions block, ring attention's step, runs the same three bodies
// under another mask:
//   flash_pos_fwd     <- _flash_pos_kernel (l.235) via _flash_pos_fwd_impl
//                        (l.596), with _masked_scores_pos (l.206) and
//                        _block_live (l.225)
//   flash_pos_bwd_dq  <- _flash_pos_bwd_dq_kernel (l.264) via
//                        _flash_pos_bwd_impl (l.636), with _recompute_p_pos (l.219)
//   flash_pos_bwd_dkv <- _flash_pos_bwd_dkv_kernel (l.298), also via _flash_pos_bwd_impl
// q (B, Sq, d) and k, v (B, Sk, d) may differ in length; qpos (Sq) and kpos
// (Sk) are int32 global positions shared by the B rows.  With ``masked`` a
// key attends when kpos < s_valid and, under causal, qpos >= kpos; without
// it every key attends.  The caller folds the lse cotangent into dd
// (dd = rowsum(dO * O) - g_lse, l.644-645).
//
// The mask is a compile-time policy of the kernels: StaticMask is the
// static-offset attention above (positions are row indices; the causal skip
// is the loop's bounds, so its code is the same as before the policy), and
// PosMask reads the position vectors.  PosMask skips a tile as _block_live
// does: when every key is pad (min kpos >= s_valid) or, under causal, lies
// after every query (min kpos > max qpos).  Each warp reduces the 64
// positions of a tile itself (two per lane and a warp min/max), so the
// decision is the same in every warp and needs no shared memory or barrier;
// a skipped tile is not loaded.  A block wholly in the future of its
// queries gives O = 0 and lse = -1e30, as _finalize writes: the float32
// bodies find so in one pass over the positions and return before they
// load a tile, the bfloat16 ones skip every tile.
//
// Grouped-query attention (GQA) runs the same three kernels: they replace
// _flash_gqa_fwd_impl (l.871) and _flash_gqa_bwd_impl (l.910), which reuse
// the Pallas bodies above and change only the index maps, as here.  q, out,
// lse, dO, dd and dq have bhq rows (batch * query heads), k, v, dk and dv
// bhk rows, with g = bhq / bhk query heads to a K/V head.  The reference's
// K/V row of query row b, _gqa_kv_row = (b / hq) * hk + (b % hq) / g (l.862),
// is b / g, since hq = g * hk; and the query rows of K/V row b, qrow =
// (b / hk) * hq + (b % hk) * g + i (l.939), are b * g + i for i < g.  So the
// kernels take bhq and bhk, and nothing else of the head layout.  Multi-head
// attention is g = 1.  K/V are never repeated in memory.
//
// Which body runs, by dtype, for all three wrappers (flash_*, flash_gqa_*,
// flash_pos_*), each body with its own note, routed by fwd_launch,
// dq_launch and dkv_launch.  float32, on the CUDA cores: the forward
// flash_fwd_f32_kernel, dq flash_bwd_dq_f32_kernel and dk/dv
// flash_bwd_dkv_f32_kernel, all in flash_f32.cuh.  bfloat16, on the tensor
// cores (mma.sync): the forward flash_fwd_bf16_kernel in flash_fwd_tc.cuh;
// dq and dk/dv flash_bwd_dq_bf16_kernel and flash_bwd_dkv_bf16_kernel in
// flash_bwd_tc.cuh.  No bfloat16 instance of a float32 body is built, and
// every body takes 16-byte cp.async loads where a row is whole 16-byte
// chunks and the operands are 16-byte aligned, element-wise loads into the
// same tiles otherwise.
//
// Semantics: top-left causal (a query at row i sees keys 0..i) or full
// attention over (S, d) rows; storage float32 or bfloat16, all
// accumulation in float32.  float32 stays full float32 (no TF32).  The
// reference's rounding points are kept: P is rounded to V's type before
// P.V and to dO's type before P^T.dO; dS is rounded to K's type before
// dS.K and to Q's type before dS^T.Q.  _finalize divides by max(l, 1e-30)
// and writes lse = m + log(l), or -1e30 where l = 0.
//
// Bound on an H100 SXM at the main path's shape, (B*H, S, d) = (64, 1024,
// 64) causal: the forward does 4*BH*S^2*d/2 = 8.6 GFLOP (0.13 ms at the
// 67 TFLOP/s float32 rate), dq 6*BH*S^2*d/2 (0.19 ms), dk/dv 8*BH*S^2*d/2
// (0.26 ms), against 34 MB of float32 inputs and outputs (0.01 ms at
// 3.35 TB/s).  So in float32 all three are compute-bound; in bfloat16 on
// the tensor cores (989 TFLOP/s) the forward at this shape is bytes-bound
// (flash_fwd_tc.cuh), dq and dk/dv still compute-bound.  The grouped
// launches at the grouped LM's shape, (bhq, bhk) = (64, 16), do the same
// FLOPs over fewer K/V bytes.
//
// The design of each body, what bounds it and what holds it back are in its
// own header's note: flash_f32.cuh (the float32 forward, dq and dk/dv on
// the CUDA cores: 128-thread blocks, row-major tiles in a two-stage
// cp.async ring, 8 x 4 register patches, P and dS through warp-private
// rows), flash_fwd_tc.cuh and flash_bwd_tc.cuh (bfloat16 on the tensor
// cores).  Every body gives a block one (row, tile of rows), and the TPU's
// sequential grid axis becomes a loop inside the block, so nothing crosses
// blocks, there are no atomics and the results repeat bit for bit; the
// causal skip of the reference (l.149-151) is the loop's bounds, and the
// heaviest causal tiles go out first.
//
// The positions kernels at the ring step's shape, (B*H, Sq, Sk, d) = (16,
// 2048, 2048, 64), count only the (q, k) pairs they must compute: a past
// block (every key before every query) has 16 * 2048^2 live pairs, the
// diagonal block half of them, a block after every query none.  At 4 (fwd),
// 6 (dq) and 8 (dk/dv) FLOP a pair and d, a past block is 17.2, 25.8 and
// 34.4 GFLOP (0.26, 0.38 and 0.51 ms at 67 TFLOP/s float32) against 17 to
// 34 MB of float32 operands (5 to 10 us at 3.35 TB/s): compute-bound, as
// the static kernels; a dead block does no FLOP, and only the launch and
// the tile decisions remain.

// The launchers, masks and bodies are in flash_launch.cuh.  This file
// instantiates D = 64 and 128 (head dims 1 to 128); flash_attention_d256.cu
// instantiates D = 256 for head dims 129 to 256, and
// flash_attention_wide.cu the wide route (flash_wide.cuh) for every head dim
// past 256, which tiles the products along d.  Each C function here forwards
// such a d there.  The three files compile at once.

#include "flash_launch.cuh"

// The one decision of which unit runs a head dim: each C function below
// branches on it, and heat_flash_route reports it.  d in (128, 256] goes to
// flash_attention_d256.cu's D = 256, d > 256 to flash_attention_wide.cu, and
// the rest stays here.
enum FlashRoute : int { kRouteTiled = 0, kRouteD256 = 1, kRouteWide = 2 };
inline int flash_route(int d) { return d > 256 ? kRouteWide : d > 128 ? kRouteD256 : kRouteTiled; }

// Dispatch on the storage type and on d: tiles are zero-padded to D = 64 or
// 128 columns here.
#define HEAT_FLASH_DISPATCH(BF16, DIM, CALL)                                      \
  do {                                                                            \
    if ((DIM) < 1) return kErrUnsupportedD;                                       \
    if (BF16) {                                                                   \
      if ((DIM) <= 64) { using T = __nv_bfloat16; constexpr int D = 64; CALL; }   \
      if ((DIM) <= 128) { using T = __nv_bfloat16; constexpr int D = 128; CALL; } \
    } else {                                                                      \
      if ((DIM) <= 64) { using T = float; constexpr int D = 64; CALL; }           \
      if ((DIM) <= 128) { using T = float; constexpr int D = 128; CALL; }         \
    }                                                                             \
    return kErrUnsupportedD;                                                      \
  } while (0)

}  // namespace

extern "C" {

// head dims in (128, 256]: flash_attention_d256.cu
int heat_flash_fwd_d256(int device, const void* q, const void* k, const void* v, void* out, float* lse, int64_t bhq,
                   int64_t bhk, int s, int d, int bf16, float scale, int causal, void* stream);
int heat_flash_bwd_dq_d256(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* dd, void* dq, int64_t bhq, int64_t bhk, int s, int d, int bf16, float scale,
                      int causal, void* stream);
int heat_flash_bwd_dkv_d256(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* dd, void* dk, void* dv, int64_t bhq, int64_t bhk, int s, int d, int bf16,
                       float scale, int causal, void* stream);
int heat_flash_pos_fwd_d256(int device, const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                       void* out, float* lse, int64_t b, int sq, int sk, int d, int bf16, float scale, int causal,
                       int s_valid, int masked, void* stream);
int heat_flash_pos_bwd_dq_d256(int device, const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* dd, const int* qpos, const int* kpos, void* dq, int64_t b,
                          int sq, int sk, int d, int bf16, float scale, int causal, int s_valid, int masked,
                          void* stream);
int heat_flash_pos_bwd_dkv_d256(int device, const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dd, const int* qpos, const int* kpos, void* dk, void* dv,
                           int64_t b, int sq, int sk, int d, int bf16, float scale, int causal, int s_valid,
                           int masked, void* stream);

// head dims past 256: flash_attention_wide.cu
int heat_flash_fwd_wide(int device, const void* q, const void* k, const void* v, void* out, float* lse, int64_t bhq,
                   int64_t bhk, int s, int d, int bf16, float scale, int causal, void* stream);
int heat_flash_bwd_dq_wide(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* dd, void* dq, int64_t bhq, int64_t bhk, int s, int d, int bf16, float scale,
                      int causal, void* stream);
int heat_flash_bwd_dkv_wide(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* dd, void* dk, void* dv, int64_t bhq, int64_t bhk, int s, int d, int bf16,
                       float scale, int causal, void* stream);
int heat_flash_pos_fwd_wide(int device, const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                       void* out, float* lse, int64_t b, int sq, int sk, int d, int bf16, float scale, int causal,
                       int s_valid, int masked, void* stream);
int heat_flash_pos_bwd_dq_wide(int device, const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* dd, const int* qpos, const int* kpos, void* dq, int64_t b,
                          int sq, int sk, int d, int bf16, float scale, int causal, int s_valid, int masked,
                          void* stream);
int heat_flash_pos_bwd_dkv_wide(int device, const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dd, const int* qpos, const int* kpos, void* dk, void* dv,
                           int64_t b, int sq, int sk, int d, int bf16, float scale, int causal, int s_valid,
                           int masked, void* stream);

// out (bhq, S, d) in the storage type and lse (bhq, S) float32 of q (bhq, S, d)
// and k, v (bhk, S, d); bhk divides bhq, and bhk = bhq is multi-head attention.
int heat_flash_fwd(int device, const void* q, const void* k, const void* v, void* out, float* lse, int64_t bhq,
                   int64_t bhk, int s, int d, int bf16, float scale, int causal, void* stream) {
  if (flash_route(d) == kRouteWide) return heat_flash_fwd_wide(device, q, k, v, out, lse, bhq, bhk, s, d, bf16, scale,
                                                               causal, stream);
  if (flash_route(d) == kRouteD256) return heat_flash_fwd_d256(device, q, k, v, out, lse, bhq, bhk, s, d, bf16, scale,
                                                               causal, stream);
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_DISPATCH(bf16, d, return (fwd_launch<T, D>(q, k, v, out, lse, bhq, bhk, d, scale, StaticMask{s, causal},
                                                        static_cast<cudaStream_t>(stream))));
}

// dq (bhq, S, d) from q, dO (bhq, S, d), k, v (bhk, S, d), lse and
// dd = rowsum(dO * O) (bhq, S) float32.
int heat_flash_bwd_dq(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* dd, void* dq, int64_t bhq, int64_t bhk, int s, int d, int bf16, float scale,
                      int causal, void* stream) {
  if (flash_route(d) == kRouteWide) return heat_flash_bwd_dq_wide(device, q, k, v, dout, lse, dd, dq, bhq, bhk, s, d,
                                                                  bf16, scale, causal, stream);
  if (flash_route(d) == kRouteD256) return heat_flash_bwd_dq_d256(device, q, k, v, dout, lse, dd, dq, bhq, bhk, s, d,
                                                                  bf16, scale, causal, stream);
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_DISPATCH(bf16, d, return (dq_launch<T, D>(q, k, v, dout, lse, dd, dq, bhq, bhk, d, scale,
                                                       StaticMask{s, causal}, static_cast<cudaStream_t>(stream))));
}

// dk, dv (bhk, S, d) from the same inputs, each summed over its group's query heads.
int heat_flash_bwd_dkv(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* dd, void* dk, void* dv, int64_t bhq, int64_t bhk, int s, int d, int bf16,
                       float scale, int causal, void* stream) {
  if (flash_route(d) == kRouteWide) return heat_flash_bwd_dkv_wide(device, q, k, v, dout, lse, dd, dk, dv, bhq, bhk,
                                                                   s, d, bf16, scale, causal, stream);
  if (flash_route(d) == kRouteD256) return heat_flash_bwd_dkv_d256(device, q, k, v, dout, lse, dd, dk, dv, bhq, bhk,
                                                                   s, d, bf16, scale, causal, stream);
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_DISPATCH(bf16, d, return (dkv_launch<T, D>(q, k, v, dout, lse, dd, dk, dv, bhq, bhk, d, scale,
                                                        StaticMask{s, causal}, static_cast<cudaStream_t>(stream))));
}

// The positions block: out (b, sq, d) in the storage type and lse (b, sq)
// float32 of q (b, sq, d), k, v (b, sk, d) and int32 positions qpos (sq),
// kpos (sk); ``masked`` applies kpos < s_valid and, under causal, qpos >= kpos.
int heat_flash_pos_fwd(int device, const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                       void* out, float* lse, int64_t b, int sq, int sk, int d, int bf16, float scale, int causal,
                       int s_valid, int masked, void* stream) {
  if (flash_route(d) == kRouteWide) return heat_flash_pos_fwd_wide(device, q, k, v, qpos, kpos, out, lse, b, sq, sk,
                                                                   d, bf16, scale, causal, s_valid, masked, stream);
  if (flash_route(d) == kRouteD256) return heat_flash_pos_fwd_d256(device, q, k, v, qpos, kpos, out, lse, b, sq, sk,
                                                                   d, bf16, scale, causal, s_valid, masked, stream);
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  const PosMask mask{qpos, kpos, sq, sk, s_valid, causal, masked};
  HEAT_FLASH_DISPATCH(bf16, d, return (fwd_launch<T, D>(q, k, v, out, lse, b, b, d, scale, mask,
                                                        static_cast<cudaStream_t>(stream))));
}

// dq (b, sq, d) of the positions block; dd = rowsum(dO * O) - g_lse.
int heat_flash_pos_bwd_dq(int device, const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* dd, const int* qpos, const int* kpos, void* dq, int64_t b,
                          int sq, int sk, int d, int bf16, float scale, int causal, int s_valid, int masked,
                          void* stream) {
  if (flash_route(d) == kRouteWide) return heat_flash_pos_bwd_dq_wide(device, q, k, v, dout, lse, dd, qpos, kpos, dq,
                                                                      b, sq, sk, d, bf16, scale, causal, s_valid,
                                                                      masked, stream);
  if (flash_route(d) == kRouteD256) return heat_flash_pos_bwd_dq_d256(device, q, k, v, dout, lse, dd, qpos, kpos, dq,
                                                                      b, sq, sk, d, bf16, scale, causal, s_valid,
                                                                      masked, stream);
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  const PosMask mask{qpos, kpos, sq, sk, s_valid, causal, masked};
  HEAT_FLASH_DISPATCH(bf16, d, return (dq_launch<T, D>(q, k, v, dout, lse, dd, dq, b, b, d, scale, mask,
                                                       static_cast<cudaStream_t>(stream))));
}

// dk, dv (b, sk, d) of the positions block.
int heat_flash_pos_bwd_dkv(int device, const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dd, const int* qpos, const int* kpos, void* dk, void* dv,
                           int64_t b, int sq, int sk, int d, int bf16, float scale, int causal, int s_valid,
                           int masked, void* stream) {
  if (flash_route(d) == kRouteWide) return heat_flash_pos_bwd_dkv_wide(device, q, k, v, dout, lse, dd, qpos, kpos, dk,
                                                                       dv, b, sq, sk, d, bf16, scale, causal, s_valid,
                                                                       masked, stream);
  if (flash_route(d) == kRouteD256) return heat_flash_pos_bwd_dkv_d256(device, q, k, v, dout, lse, dd, qpos, kpos, dk,
                                                                       dv, b, sq, sk, d, bf16, scale, causal, s_valid,
                                                                       masked, stream);
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  const PosMask mask{qpos, kpos, sq, sk, s_valid, causal, masked};
  HEAT_FLASH_DISPATCH(bf16, d, return (dkv_launch<T, D>(q, k, v, dout, lse, dd, dk, dv, b, b, d, scale, mask,
                                                        static_cast<cudaStream_t>(stream))));
}

// The route the C functions above take at head dim d: 0 (the D = 64 and 128
// bodies of this file), 1 (flash_attention_d256.cu), 2 (the wide route of
// flash_attention_wide.cu), or kErrUnsupportedD below d = 1.
int heat_flash_route(int d) { return d < 1 ? kErrUnsupportedD : flash_route(d); }

const char* heat_flash_strerror(int code) {
  if (code == kErrUnsupportedD) return "the flash-attention kernels take d >= 1";
  if (code == kErrSharedMemory) return "the flash-attention tiles need more shared memory than this card gives a block";
  if (code == kErrBadShape)
    return "bad shape: the K/V rows must divide the query rows, and rows*ceil(S/64) fit a 31-bit grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
