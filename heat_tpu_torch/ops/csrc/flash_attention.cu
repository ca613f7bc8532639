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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "device_guard.cuh"

namespace {

constexpr int kErrUnsupportedD = -1;
constexpr int kErrSharedMemory = -2;
constexpr int kErrBadShape = -3;

constexpr int BQ = 64;        // query rows of a tile
constexpr int BK = 64;        // key rows of a tile (== BQ: the causal bounds below rely on it)
constexpr int PAD = 4;        // padding of each shared row, in floats: keeps 16-byte alignment
constexpr int TS = 64 + PAD;  // stride of a 64-column tile: P, dS, P^T, dS^T [rows][64]
constexpr float kNoMass = -1e30f;
// The bfloat16 forward's block: 4 warps of 16 query rows, one BQ tile, so
// the masks' key_end and query_bound hold for it; and the blocks an SM that
// ptxas budgets registers for: 3 at D = 64 (<= 170 registers), 2 at
// D = 128 (<= 255).  8 warps or 4 blocks cap a thread at 128 registers,
// where D = 64 spills.
constexpr int kFwdWarps = 4;
static_assert(16 * kFwdWarps == BQ, "the bfloat16 forward's query tile is the masks' BQ");
template <int D>
constexpr int kFwdMinBlocks = D == 64 ? 3 : 2;

static_assert(BQ == BK, "the causal loop bounds assume square tiles");

// The mask of the static-offset kernels: one sequence of S rows for q and
// K/V; a row's position is its index.  The score mask of _masked_scores
// drops keys past S and, under causal, the future; the causal skip of the
// reference (l.149-151, 350-352, 395-397) is the loops' bounds, so every
// tile in them is live.
struct StaticMask {
  int S, causal;
  __host__ __device__ __forceinline__ int q_rows() const { return S; }
  __host__ __device__ __forceinline__ int k_rows() const { return S; }
  __device__ __forceinline__ int q_pos(int row) const { return row; }
  __device__ __forceinline__ int k_pos(int col) const { return col; }
  __device__ __forceinline__ bool dead(int qp, int kp, int col) const { return col >= S || (causal && kp > qp); }
  // forward and dq: query tile iq reads key tiles [0, key_end(iq)): all, or under causal up to the diagonal
  __device__ __forceinline__ int key_end(int iq) const {
    const int nk = (S + BK - 1) / BK;
    return causal ? min(nk, iq + 1) : nk;
  }
  __device__ __forceinline__ int query_bound(int) const { return 0; }
  // dk/dv: key tile ik is read by query tiles [query_begin(ik), nq)
  __device__ __forceinline__ int query_begin(int ik) const { return causal ? ik : 0; }
  // the bfloat16 forward (flash_fwd_tc.cuh), by warps of 16 query rows:
  // (min, max) position of the warp's rows from r0, and of the keys of tile k0
  __device__ __forceinline__ int2 fwd_warp_span(int r0) const { return make_int2(r0, r0 + 15); }
  __device__ __forceinline__ int2 fwd_tile_range(int k0) const { return make_int2(k0, k0 + BK - 1); }
  __device__ __forceinline__ bool fwd_block_live(int2, int) const { return true; }  // the loop's bounds skip
  // the warp sees some key of the tile: under causal, not every key is after its last row
  __device__ __forceinline__ bool fwd_warp_live(int2 keys, int2 span) const { return !causal || keys.x <= span.y; }
  // every key of the tile is live for every row of the warp: no element mask
  __device__ __forceinline__ bool fwd_tile_full(int2 keys, int2 span) const {
    return keys.y < S && (!causal || keys.y <= span.x);
  }
  // the bfloat16 dk/dv (flash_bwd_tc.cuh), by warps of 16 keys against a
  // 64-query tile: (min, max) position of the warp's keys from r0, and of the
  // queries of tile q0 (the tile's liveness is the loop's bounds, query_begin)
  __device__ __forceinline__ int2 bwd_warp_span(int r0) const { return make_int2(r0, r0 + 15); }
  __device__ __forceinline__ int2 bwd_tile_range(int q0) const { return make_int2(q0, q0 + BQ - 1); }
  // some query of the tile sees some key of the warp: under causal, not every key is after its last query
  __device__ __forceinline__ bool bwd_warp_live(int2 queries, int2 keys) const {
    return !causal || keys.x <= queries.y;
  }
  // every key of the warp is live for every query of the tile: no element
  // mask (queries past the rows: the caller checks them)
  __device__ __forceinline__ bool bwd_tile_full(int2 queries, int2 keys) const {
    return keys.y < S && (!causal || keys.y <= queries.x);
  }
};

// max over the positions [r0, r0 + 64) of a tile that lie below n,
// computed by each warp alone (two entries a lane), so every warp of the
// block gets the same value without a barrier
__device__ __forceinline__ int tile_max(const int* __restrict__ pos, int r0, int n) {
  const int lane = threadIdx.x % 32, a = r0 + lane, b = a + 32;
  return __reduce_max_sync(0xffffffffu, max(a < n ? pos[a] : INT_MIN, b < n ? pos[b] : INT_MIN));
}

// (min, max) over the positions [r0, r0 + 16) that lie below n, the same in
// every lane of the warp (lanes 0-15 and 16-31 read the same 16)
__device__ __forceinline__ int2 warp_span(const int* __restrict__ pos, int r0, int n) {
  const int r = r0 + int(threadIdx.x % 16);
  return make_int2(__reduce_min_sync(0xffffffffu, r < n ? pos[r] : INT_MAX),
                   __reduce_max_sync(0xffffffffu, r < n ? pos[r] : INT_MIN));
}
// (min, max) over the positions [r0, r0 + 64) that lie below n: one read of
// two positions a lane, the same in every lane
__device__ __forceinline__ int2 tile_span(const int* __restrict__ pos, int r0, int n) {
  const int lane = threadIdx.x % 32, a = r0 + lane, b = a + 32;
  const int pa = a < n ? pos[a] : 0, pb = b < n ? pos[b] : 0;
  return make_int2(__reduce_min_sync(0xffffffffu, min(a < n ? pa : INT_MAX, b < n ? pb : INT_MAX)),
                   __reduce_max_sync(0xffffffffu, max(a < n ? pa : INT_MIN, b < n ? pb : INT_MIN)));
}

// The mask of the positions block (_masked_scores_pos): q of Sq rows, K/V
// of Sk rows, global positions qpos (Sq) and kpos (Sk).  Keys past Sk are
// dead; with ``masked`` a key attends when kpos < s_valid and, under
// causal, kpos <= qpos.  Tiles are skipped by _block_live: a bound of the
// tile the block owns (max qpos for the forward and dq, min kpos for dk/dv)
// is taken once, the other per tile in the loop.
struct PosMask {
  const int* qpos;
  const int* kpos;
  int Sq, Sk, s_valid, causal, masked;
  __host__ __device__ __forceinline__ int q_rows() const { return Sq; }
  __host__ __device__ __forceinline__ int k_rows() const { return Sk; }
  __device__ __forceinline__ int q_pos(int row) const { return row < Sq ? qpos[row] : 0; }  // rows past Sq: unwritten
  __device__ __forceinline__ int k_pos(int col) const { return col < Sk ? kpos[col] : 0; }  // keys past Sk: dead
  __device__ __forceinline__ bool dead(int qp, int kp, int col) const {
    return col >= Sk || (masked && (kp >= s_valid || (causal && kp > qp)));
  }
  __device__ __forceinline__ int key_end(int) const { return (Sk + BK - 1) / BK; }
  __device__ __forceinline__ int query_bound(int q0) const { return masked && causal ? tile_max(qpos, q0, Sq) : 0; }
  __device__ __forceinline__ int query_begin(int) const { return 0; }
  // the bfloat16 forward (flash_fwd_tc.cuh), by warps of 16 query rows:
  // (min, max) position of the warp's rows from r0 below Sq (lanes 0-15 and
  // 16-31 read the same 16), and of the keys of tile k0 below Sk: one read
  // of two positions a lane, taken once a tile by each warp
  __device__ __forceinline__ int2 fwd_warp_span(int r0) const { return warp_span(qpos, r0, Sq); }
  __device__ __forceinline__ int2 fwd_tile_range(int k0) const {
    return masked ? tile_span(kpos, k0, Sk) : make_int2(0, 0);
  }
  // _block_live on the tile's range
  __device__ __forceinline__ bool fwd_block_live(int2 keys, int qmax) const {
    return !masked || (keys.x < s_valid && (!causal || keys.x <= qmax));
  }
  // the warp sees some key of a tile the block found live
  __device__ __forceinline__ bool fwd_warp_live(int2 keys, int2 span) const {
    return !(masked && causal) || keys.x <= span.y;
  }
  // every key of the tile is live for every row of the warp: no element mask
  // (keys past Sk are dead; the caller checks them)
  __device__ __forceinline__ bool fwd_tile_full(int2 keys, int2 span) const {
    return !masked || (keys.y < s_valid && (!causal || keys.y <= span.x));
  }
  // the bfloat16 dk/dv (flash_bwd_tc.cuh), by warps of 16 keys against a
  // 64-query tile: (min, max) position of the warp's keys from r0 below Sk,
  // and of the queries of tile q0 below Sq; a tile is live for the block as
  // fwd_block_live(the block's keys, the tile's max query) says
  __device__ __forceinline__ int2 bwd_warp_span(int r0) const { return warp_span(kpos, r0, Sk); }
  __device__ __forceinline__ int2 bwd_tile_range(int q0) const {
    return masked ? tile_span(qpos, q0, Sq) : make_int2(0, 0);
  }
  // some key of the warp is not pad and, under causal, not after every query of the tile
  __device__ __forceinline__ bool bwd_warp_live(int2 queries, int2 keys) const {
    return !masked || (keys.x < s_valid && (!causal || keys.x <= queries.y));
  }
  // every key of the warp is live for every query of the tile: no element mask
  __device__ __forceinline__ bool bwd_tile_full(int2 queries, int2 keys) const {
    return !masked || (keys.y < s_valid && (!causal || keys.y <= queries.x));
  }
};

#include "flash_fwd_tc.cuh"  // the bfloat16 forward: flash_fwd_bf16_kernel
#include "flash_bwd_tc.cuh"  // the bfloat16 backward: flash_bwd_dq_bf16_kernel, flash_bwd_dkv_bf16_kernel
#include "flash_f32.cuh"  // float32: flash_fwd_f32_kernel, flash_bwd_dq_f32_kernel, flash_bwd_dkv_f32_kernel

// Blocks of a grid over ``rows`` rows of n positions in 64-row tiles.
int64_t tiles_of(int64_t rows, int n) { return rows * ((int64_t(n) + 63) / 64); }

// Check the shape, set the kernel's dynamic shared memory and launch it on
// ``blocks`` blocks of ``threads`` threads with ``args``; 0 or an error code.
// ``blocks`` is the grid: query tiles for the forward and dq, key tiles for
// dk/dv.
template <typename Mask, typename... P, typename... A>
int launch(void (*kern)(P...), size_t smem, int threads, int64_t blocks, int64_t bhq, int64_t bhk, const Mask& mask,
           cudaStream_t stream, A... args) {
  const bool rows_ok = bhk == 0 ? bhq == 0 : bhq >= 0 && bhk > 0 && bhq % bhk == 0;
  if (!rows_ok || mask.q_rows() < 0 || mask.k_rows() < 0 || blocks > 0x7fffffff) return kErrBadShape;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return int(err);
  if (smem > size_t(max_smem)) return kErrSharedMemory;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (blocks == 0) return 0;
  kern<<<int(blocks), threads, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

// Query heads per K/V row; launch checks the rows before it launches.
int group_of(int64_t bhq, int64_t bhk) { return bhk > 0 ? int(bhq / bhk) : 0; }

// Every kernel takes VEC (16-byte loads and stores) where a row is whole 16-byte chunks, d % E == 0 for E
// elements in 16 bytes (8 bfloat16, 4 float32), and every operand is
// 16-byte aligned, else go element by element.
template <int E, typename... P>
bool vec_ok(int d, const P*... ptrs) {
  return d % E == 0 && ((reinterpret_cast<uintptr_t>(ptrs) | ...) % 16) == 0;
}

using B = __nv_bfloat16;

template <typename T, int D, typename Mask>
int fwd_launch(const void* q, const void* k, const void* v, void* out, float* lse, int64_t bhq, int64_t bhk, int d,
               float scale, Mask mask, cudaStream_t stream) {
  const int64_t blocks = tiles_of(bhq, mask.q_rows());
  const int g = group_of(bhq, bhk);
  if constexpr (std::is_same_v<T, B>) {
    const auto kern = vec_ok<8>(d, q, k, v, out) ? flash_fwd_bf16_kernel<D, true, Mask>
                                              : flash_fwd_bf16_kernel<D, false, Mask>;
    return launch(kern, fwd_bf16_smem<D>(), 32 * kFwdWarps, blocks, bhq, bhk, mask, stream,
                  static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v), static_cast<B*>(out),
                  lse, int(bhq), d, g, scale, mask);
  } else {
    const auto kern = vec_ok<4>(d, q, k, v, out) ? flash_fwd_f32_kernel<D, true, Mask>
                                                 : flash_fwd_f32_kernel<D, false, Mask>;
    return launch(kern, fwd_f32_smem<D>(), kF32Threads, blocks, bhq, bhk, mask, stream,
                  static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                  static_cast<float*>(out), lse, int(bhq), d, g, scale, mask);
  }
}

// bfloat16 dq and dk/dv run on the tensor cores (flash_bwd_tc.cuh), float32 on
// the CUDA cores (flash_f32.cuh)
template <typename T, int D, typename Mask>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* dd,
              void* dq, int64_t bhq, int64_t bhk, int d, float scale, Mask mask, cudaStream_t stream) {
  const int64_t blocks = tiles_of(bhq, mask.q_rows());
  const int g = group_of(bhq, bhk);
  if constexpr (std::is_same_v<T, B>) {
    const auto kern = vec_ok<8>(d, q, k, v, dout, dq) ? flash_bwd_dq_bf16_kernel<D, true, Mask>
                                                   : flash_bwd_dq_bf16_kernel<D, false, Mask>;
    return launch(kern, dq_bf16_smem<D>(), 32 * kBwdWarps, blocks, bhq, bhk, mask, stream,
                  static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
                  static_cast<const B*>(dout), lse, dd, static_cast<B*>(dq), int(bhq), d, g, scale, mask);
  } else {
    const auto kern = vec_ok<4>(d, q, k, v, dout, dq) ? flash_bwd_dq_f32_kernel<D, true, Mask>
                                                      : flash_bwd_dq_f32_kernel<D, false, Mask>;
    return launch(kern, dq_f32_smem<D>(), kF32Threads, blocks, bhq, bhk, mask, stream,
                  static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                  static_cast<const float*>(dout), lse, dd, static_cast<float*>(dq), int(bhq), d, g, scale, mask);
  }
}

template <typename T, int D, typename Mask>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* dd,
               void* dk, void* dv, int64_t bhq, int64_t bhk, int d, float scale, Mask mask, cudaStream_t stream) {
  const int g = group_of(bhq, bhk);
  if constexpr (std::is_same_v<T, B>) {
    const int64_t blocks = tiles_of(bhk, mask.k_rows());
    const auto kern = vec_ok<8>(d, q, k, v, dout, dk, dv) ? flash_bwd_dkv_bf16_kernel<D, true, Mask>
                                                       : flash_bwd_dkv_bf16_kernel<D, false, Mask>;
    return launch(kern, dkv_bf16_smem<D>(), 32 * kBwdWarps, blocks, bhq, bhk, mask, stream,
                  static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
                  static_cast<const B*>(dout), lse, dd, static_cast<B*>(dk), static_cast<B*>(dv), int(bhk), d, g,
                  scale, mask);
  } else {
    const int64_t blocks = bhk * ((int64_t(mask.k_rows()) + kDkvKeys - 1) / kDkvKeys);
    const auto kern = vec_ok<4>(d, q, k, v, dout, dk, dv) ? flash_bwd_dkv_f32_kernel<D, true, Mask>
                                                          : flash_bwd_dkv_f32_kernel<D, false, Mask>;
    return launch(kern, dkv_f32_smem<D>(), kF32Threads, blocks, bhq, bhk, mask, stream,
                  static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                  static_cast<const float*>(dout), lse, dd, static_cast<float*>(dk), static_cast<float*>(dv),
                  int(bhk), d, g, scale, mask);
  }
}

// Dispatch on the storage type and on d: tiles are zero-padded to D = 64 or 128 columns.
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

// out (bhq, S, d) in the storage type and lse (bhq, S) float32 of q (bhq, S, d)
// and k, v (bhk, S, d); bhk divides bhq, and bhk = bhq is multi-head attention.
int heat_flash_fwd(int device, const void* q, const void* k, const void* v, void* out, float* lse, int64_t bhq,
                   int64_t bhk, int s, int d, int bf16, float scale, int causal, void* stream) {
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
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_DISPATCH(bf16, d, return (dq_launch<T, D>(q, k, v, dout, lse, dd, dq, bhq, bhk, d, scale,
                                                       StaticMask{s, causal}, static_cast<cudaStream_t>(stream))));
}

// dk, dv (bhk, S, d) from the same inputs, each summed over its group's query heads.
int heat_flash_bwd_dkv(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* dd, void* dk, void* dv, int64_t bhq, int64_t bhk, int s, int d, int bf16,
                       float scale, int causal, void* stream) {
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
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  const PosMask mask{qpos, kpos, sq, sk, s_valid, causal, masked};
  HEAT_FLASH_DISPATCH(bf16, d, return (dkv_launch<T, D>(q, k, v, dout, lse, dd, dk, dv, b, b, d, scale, mask,
                                                        static_cast<cudaStream_t>(stream))));
}

const char* heat_flash_strerror(int code) {
  if (code == kErrUnsupportedD) return "the flash-attention kernels take 1 <= d <= 128";
  if (code == kErrSharedMemory) return "the flash-attention tiles need more shared memory than this card gives a block";
  if (code == kErrBadShape)
    return "bad shape: the K/V rows must divide the query rows, and rows*ceil(S/64) fit a 31-bit grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
