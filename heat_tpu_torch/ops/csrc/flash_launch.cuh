// The flash-attention launchers shared by flash_attention.cu (head dims
// 1 to 128: D = 64 and 128), flash_attention_d256.cu (129 to 256: D =
// 256) and flash_attention_wide.cu (past 256: the route of flash_wide.cuh
// and flash_wide_bwd.cuh, which uses the masks, ``launch`` and
// ``launch_cluster`` here), three translation units so that nvcc
// builds them at once.  Each includes this header once: the mask policies,
// the three bodies of each dtype and fwd_launch, dq_launch and dkv_launch,
// in an anonymous namespace that the including file closes after its
// dispatch macro.  flash_attention.cu's note describes the kernels.

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
// D = 128 (<= 255), 1 at D = 256 (shared memory allows no more).  8 warps
// or 4 blocks cap a thread at 128 registers, where D = 64 spills.
constexpr int kFwdWarps = 4;
static_assert(16 * kFwdWarps == BQ, "the bfloat16 forward's query tile is the masks' BQ");
template <int D>
constexpr int kFwdMinBlocks = D == 64 ? 3 : D == 128 ? 2 : 1;

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

// Check the shape and set the kernel's dynamic shared memory: 0, or an
// error code.  ``blocks`` is the grid: query tiles for the forward and dq,
// key tiles for dk/dv.
template <typename Mask, typename... P>
int prepare_launch(void (*kern)(P...), size_t smem, int64_t blocks, int64_t bhq, int64_t bhk, const Mask& mask) {
  const bool rows_ok = bhk == 0 ? bhq == 0 : bhq >= 0 && bhk > 0 && bhq % bhk == 0;
  if (!rows_ok || mask.q_rows() < 0 || mask.k_rows() < 0 || blocks > 0x7fffffff) return kErrBadShape;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return int(err);
  if (smem > size_t(max_smem)) return kErrSharedMemory;
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

// Launch ``kern`` on ``blocks`` blocks of ``threads`` threads with ``args``
// after prepare_launch; 0 or an error code.
template <typename Mask, typename... P, typename... A>
int launch(void (*kern)(P...), size_t smem, int threads, int64_t blocks, int64_t bhq, int64_t bhk, const Mask& mask,
           cudaStream_t stream, A... args) {
  const int err = prepare_launch(kern, smem, blocks, bhq, bhk, mask);
  if (err != 0 || blocks == 0) return err;
  kern<<<int(blocks), threads, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

// The same in thread block clusters of ``cluster`` consecutive blocks
// (cudaLaunchKernelEx); a cluster the card cannot place fails the launch.
template <typename Mask, typename... P, typename... A>
int launch_cluster(void (*kern)(P...), size_t smem, int threads, int64_t blocks, int cluster, int64_t bhq,
                   int64_t bhk, const Mask& mask, cudaStream_t stream, A... args) {
  if (cluster < 1 || blocks % cluster != 0) return kErrBadShape;
  const int err = prepare_launch(kern, smem, blocks, bhq, bhk, mask);
  if (err != 0 || blocks == 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(blocks));
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kern, args...);
  if (launched != cudaSuccess) return int(launched);
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
    const int64_t f32_blocks = bhq * ((int64_t(mask.q_rows()) + kDqRows<D> - 1) / kDqRows<D>);
    return launch(kern, dq_f32_smem<D>(), kF32Threads, f32_blocks, bhq, bhk, mask, stream,
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

