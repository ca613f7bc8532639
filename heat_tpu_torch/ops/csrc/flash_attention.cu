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
// Semantics: top-left causal (a query at row i sees keys 0..i) or full
// attention over identical (S, d) shapes; storage float32 or bfloat16, all
// accumulation in float32 on the CUDA cores.  float32 stays full float32
// (no TF32).  The reference's rounding points are kept: P is rounded to V's
// type before P.V and to dO's type before P^T.dO; dS is rounded to K's type
// before dS.K and to Q's type before dS^T.Q.  _finalize divides by
// max(l, 1e-30) and writes lse = m + log(l), or -1e30 where l = 0.
//
// Bound on an H100 SXM at the main path's shape, (B*H, S, d) = (64, 1024,
// 64) causal: the forward does 4*BH*S^2*d/2 = 8.6 GFLOP (0.13 ms at the
// 67 TFLOP/s float32 rate), dq 6*BH*S^2*d/2 (0.19 ms), dk/dv 8*BH*S^2*d/2
// (0.26 ms), against 34 MB of float32 inputs and outputs (0.01 ms at
// 3.35 TB/s).  So all three are compute-bound, and in bfloat16 on the tensor
// cores (989 TFLOP/s) they would still be.  This first version spends its
// effort on being right and simple:
//   * one block of 256 threads per (batch*head, 64-row tile); the TPU's
//     sequential grid axis becomes a loop inside the block: over key tiles
//     for the forward and dq (one block per query tile), over query tiles
//     for dk/dv (one block per key tile).  Nothing crosses blocks, so there
//     are no atomics and the results repeat bit for bit;
//   * the causal skip of the reference (l.149-151, 350-352, 395-397) is the
//     loop's bounds; heavy causal tiles are launched first;
//   * tiles are 64 x 64, not the TPU's 512 x 512: they are staged in shared
//     memory as float32 (the largest, dk/dv at d = 128, takes 220 KB of the
//     227 KB a block may use) and each thread holds a 4 x 4 patch of every
//     64 x 64 product in registers, fed by 16-byte shared-memory reads;
//   * the ragged last tile is masked inside the kernel (rows >= S load as
//     zeros, keys >= S are masked); S is never padded in device memory.
// wgmma/TMA pipelines and bfloat16 tensor-core products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kErrUnsupportedD = -1;
constexpr int kErrSharedMemory = -2;
constexpr int kErrBadShape = -3;

constexpr int BQ = 64;        // query rows of a tile
constexpr int BK = 64;        // key rows of a tile (== BQ: the causal bounds below rely on it)
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 patch of a 64 x 64 product
constexpr int PAD = 4;        // padding of each shared row, in floats: keeps 16-byte alignment
constexpr int TS = 64 + PAD;  // stride of a transposed tile [D][64]
constexpr float kNoMass = -1e30f;

static_assert(BQ == BK, "the causal loop bounds assume square tiles");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// float32 -> storage type -> float32: the reference's astype before a GEMM
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// Rows [r0, r0 + 64) of a row-major (S, d) matrix into shared memory as
// float32: row-major rm[r][c] (stride D + PAD) and/or transposed tr[c][r]
// (stride TS).  Rows >= S and columns >= d are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0, int S, int d, float* rm, float* tr) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, c = e % D;
    float v = 0.f;
    if (r0 + r < S && c < d) v = to_f32(src[int64_t(r0 + r) * d + c]);
    if (rm) rm[r * (D + PAD) + c] = v;
    if (tr) tr[c * TS + r] = v;
  }
}

// acc[i][g*4 + j] += sum_{k < N} a[k][ty*4 + i] * b[k][g*64 + tx*4 + j]
template <int NG, int N>
__device__ __forceinline__ void mm_patch(float (&acc)[4][NG * 4], const float* a, int lda, const float* b, int ldb,
                                         int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < N; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * lda + ty * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb + g * 64 + tx * 4);
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][g * 4 + j] = fmaf(ar[i], br[j], acc[i][g * 4 + j]);
    }
  }
}

// reductions over the 16 threads that share a row (lanes differing in tx)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the score mask of _masked_scores: keys past S, and the future under causal
__device__ __forceinline__ bool masked(int row, int col, int S, int causal) {
  return col >= S || (causal && col > row);
}

// key tiles that query tile iq reads: all, or under causal those up to the diagonal
__device__ __forceinline__ int key_tiles(int iq, int S, int causal) {
  const int nk = (S + BK - 1) / BK;
  return causal ? min(nk, iq + 1) : nk;
}

template <int D>
constexpr size_t fwd_smem() {  // qt, kt [D][TS]; vs [BK][D + PAD]; pt [BK][TS]
  return sizeof(float) * (2 * D * TS + BK * (D + PAD) + BK * TS);
}
template <int D>
constexpr size_t dq_smem() {  // qt, dot, kt, vt [D][TS]; ks [BK][D + PAD]; dst [BK][TS]
  return sizeof(float) * (4 * D * TS + BK * (D + PAD) + BK * TS);
}
template <int D>
constexpr size_t dkv_smem() {  // kt, vt, qt, dot [D][TS]; qs, dos [BQ][D + PAD]; pt [BQ][TS]; lse, dd [BQ]
  return sizeof(float) * (4 * D * TS + 2 * BQ * (D + PAD) + BQ * TS + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int S, int d, float scale, int causal) {
  constexpr int NG = D / 64;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + D * TS;
  float* vs = kt + D * TS;
  float* pt = vs + BK * (D + PAD);

  const int nq = (S + BQ - 1) / BQ;
  const int64_t bh = blockIdx.x / nq;
  const int iq = nq - 1 - int(blockIdx.x % nq);  // longest causal rows first
  const int q0 = iq * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t base = bh * S * int64_t(d);
  q += base;
  k += base;
  v += base;

  load_tile<T, D>(q, q0, S, d, nullptr, qt);
  float m[4], l[4], acc[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(iq, S, causal);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(k, k0, S, d, nullptr, kt);
    load_tile<T, D>(v, k0, S, d, vs, nullptr);
    __syncthreads();
    float s[4][4] = {};
    mm_patch<1, D>(s, qt, TS, kt, TS, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked(row, k0 + tx * 4 + j, S, causal) ? -INFINITY : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      // _online_update: rows with no live key so far keep m = -inf
      const float m_new = fmaxf(m[i], row_max(mx));
      const float safe = isfinite(m_new) ? m_new : 0.f;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = isfinite(s[i][j]) ? expf(s[i][j] - safe) : 0.f;  // now p
        ps += s[i][j];
      }
      const float corr = isfinite(m[i]) ? expf(m[i] - safe) : 0.f;
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NG * 4; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)  // P^T, rounded to V's type
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * TS + ty * 4) =
          make_float4(round_to<T>(s[0][j]), round_to<T>(s[1][j]), round_to<T>(s[2][j]), round_to<T>(s[3][j]));
    __syncthreads();
    mm_patch<NG, BK>(acc, pt, TS, vs, D + PAD, ty, tx);
  }

  // _finalize
  out += base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g * 64 + tx * 4 + j;
        if (c < d) out[int64_t(row) * d + c] = from_f32<T>(acc[i][g * 4 + j] / den);
      }
    if (tx == 0) lse[bh * S + row] = l[i] > 0.f ? (isfinite(m[i]) ? m[i] : 0.f) + logf(den) : kNoMass;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
                        T* __restrict__ dq, int S, int d, float scale, int causal) {
  constexpr int NG = D / 64;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* dot = qt + D * TS;
  float* kt = dot + D * TS;
  float* vt = kt + D * TS;
  float* ks = vt + D * TS;
  float* dst = ks + BK * (D + PAD);

  const int nq = (S + BQ - 1) / BQ;
  const int64_t bh = blockIdx.x / nq;
  const int iq = nq - 1 - int(blockIdx.x % nq);
  const int q0 = iq * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t base = bh * S * int64_t(d);
  q += base;
  k += base;
  v += base;
  dout += base;

  load_tile<T, D>(q, q0, S, d, nullptr, qt);
  load_tile<T, D>(dout, q0, S, d, nullptr, dot);
  float lse_r[4], dd_r[4], acc[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < S ? lse[bh * S + row] : 0.f;
    dd_r[i] = row < S ? dd[bh * S + row] : 0.f;
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(iq, S, causal);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();
    load_tile<T, D>(k, k0, S, d, ks, kt);
    load_tile<T, D>(v, k0, S, d, nullptr, vt);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_patch<1, D>(s, qt, TS, kt, TS, ty, tx);    // Q K^T
    mm_patch<1, D>(dp, dot, TS, vt, TS, ty, tx);  // dO V^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        const float p = masked(row, k0 + tx * 4 + j, S, causal) ? 0.f : expf(s[i][j] * scale - lse_r[i]);
        ds[i] = round_to<T>(p * (dp[i][j] - dd_r[i]) * scale);  // dS, rounded to K's type
      }
      *reinterpret_cast<float4*>(dst + (tx * 4 + j) * TS + ty * 4) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    mm_patch<NG, BK>(acc, dst, TS, ks, D + PAD, ty, tx);  // dS K
  }

  dq += base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g * 64 + tx * 4 + j;
        if (c < d) dq[int64_t(row) * d + c] = from_f32<T>(acc[i][g * 4 + j]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
                         T* __restrict__ dk, T* __restrict__ dv, int S, int d, float scale, int causal) {
  constexpr int NG = D / 64;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);
  float* vt = kt + D * TS;
  float* qt = vt + D * TS;
  float* dot = qt + D * TS;
  float* qs = dot + D * TS;
  float* dos = qs + BQ * (D + PAD);
  float* pt = dos + BQ * (D + PAD);
  float* lse_s = pt + BQ * TS;
  float* dd_s = lse_s + BQ;

  const int nk = (S + BK - 1) / BK;
  const int64_t bh = blockIdx.x / nk;
  const int ik = int(blockIdx.x % nk);  // under causal the first key tiles have the most work
  const int k0 = ik * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t base = bh * S * int64_t(d);
  q += base;
  k += base;
  v += base;
  dout += base;

  load_tile<T, D>(k, k0, S, d, nullptr, kt);
  load_tile<T, D>(v, k0, S, d, nullptr, vt);
  float dk_acc[4][NG * 4], dv_acc[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // query tiles that see this key tile: all, or under causal those from the diagonal on
  const int nq = (S + BQ - 1) / BQ;
  for (int iq = causal ? ik : 0; iq < nq; ++iq) {
    const int q0 = iq * BQ;
    __syncthreads();
    load_tile<T, D>(q, q0, S, d, qs, qt);
    load_tile<T, D>(dout, q0, S, d, dos, dot);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < S ? lse[bh * S + row] : 0.f;
      dd_s[threadIdx.x] = row < S ? dd[bh * S + row] : 0.f;
    }
    __syncthreads();
    // this thread's patch: key rows k0 + ty*4 + i, query columns q0 + tx*4 + j
    float st[4][4] = {}, dpt[4][4] = {};
    mm_patch<1, D>(st, kt, TS, qt, TS, ty, tx);    // (Q K^T)^T
    mm_patch<1, D>(dpt, vt, TS, dot, TS, ty, tx);  // (dO V^T)^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = q0 + tx * 4 + j;
      const float lse_c = lse_s[tx * 4 + j], dd_c = dd_s[tx * 4 + j];
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // query rows past S are zero padding: they take part in nothing
        const bool dead = col >= S || masked(col, k0 + ty * 4 + i, S, causal);
        p[i] = dead ? 0.f : expf(st[i][j] * scale - lse_c);
        st[i][j] = p[i] * (dpt[i][j] - dd_c) * scale;  // now dS^T
      }
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * TS + ty * 4) =  // P, rounded to dO's type
          make_float4(round_to<T>(p[0]), round_to<T>(p[1]), round_to<T>(p[2]), round_to<T>(p[3]));
    }
    __syncthreads();
    mm_patch<NG, BQ>(dv_acc, pt, TS, dos, D + PAD, ty, tx);  // P^T dO
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j)  // dS, rounded to Q's type
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * TS + ty * 4) = make_float4(
          round_to<T>(st[0][j]), round_to<T>(st[1][j]), round_to<T>(st[2][j]), round_to<T>(st[3][j]));
    __syncthreads();
    mm_patch<NG, BQ>(dk_acc, pt, TS, qs, D + PAD, ty, tx);  // dS^T Q
  }

  dk += base;
  dv += base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g * 64 + tx * 4 + j;
        if (c < d) {
          dk[int64_t(row) * d + c] = from_f32<T>(dk_acc[i][g * 4 + j]);
          dv[int64_t(row) * d + c] = from_f32<T>(dv_acc[i][g * 4 + j]);
        }
      }
  }
}

// Set the kernel's dynamic shared memory and check the grid; 0 or an error code.
template <typename Kernel>
int prepare(Kernel kern, size_t smem, int64_t bh, int S) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return int(err);
  if (smem > size_t(max_smem)) return kErrSharedMemory;
  const int64_t blocks = bh * ((S + 63) / 64);
  if (bh < 0 || S < 0 || blocks > 0x7fffffff) return kErrBadShape;
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

int grid_of(int64_t bh, int S) { return int(bh * ((S + 63) / 64)); }

template <typename T, int D>
int fwd_launch(const void* q, const void* k, const void* v, void* out, float* lse, int64_t bh, int S, int d,
               float scale, int causal, cudaStream_t stream) {
  const int err = prepare(flash_fwd_kernel<T, D>, fwd_smem<D>(), bh, S);
  if (err != 0) return err;
  if (grid_of(bh, S) == 0) return 0;
  flash_fwd_kernel<T, D><<<grid_of(bh, S), THREADS, fwd_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), lse, S, d,
      scale, causal);
  return int(cudaGetLastError());
}

template <typename T, int D>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* dd,
              void* dq, int64_t bh, int S, int d, float scale, int causal, cudaStream_t stream) {
  const int err = prepare(flash_bwd_dq_kernel<T, D>, dq_smem<D>(), bh, S);
  if (err != 0) return err;
  if (grid_of(bh, S) == 0) return 0;
  flash_bwd_dq_kernel<T, D><<<grid_of(bh, S), THREADS, dq_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), lse,
      dd, static_cast<T*>(dq), S, d, scale, causal);
  return int(cudaGetLastError());
}

template <typename T, int D>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* dd,
               void* dk, void* dv, int64_t bh, int S, int d, float scale, int causal, cudaStream_t stream) {
  const int err = prepare(flash_bwd_dkv_kernel<T, D>, dkv_smem<D>(), bh, S);
  if (err != 0) return err;
  if (grid_of(bh, S) == 0) return 0;
  flash_bwd_dkv_kernel<T, D><<<grid_of(bh, S), THREADS, dkv_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), lse,
      dd, static_cast<T*>(dk), static_cast<T*>(dv), S, d, scale, causal);
  return int(cudaGetLastError());
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

// out (bh, S, d) in the storage type and lse (bh, S) float32 of q, k, v (bh, S, d).
int heat_flash_fwd(int device, const void* q, const void* k, const void* v, void* out, float* lse, int64_t bh, int s,
                   int d, int bf16, float scale, int causal, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_DISPATCH(bf16, d, return (fwd_launch<T, D>(q, k, v, out, lse, bh, s, d, scale, causal,
                                                        static_cast<cudaStream_t>(stream))));
}

// dq (bh, S, d) from q, k, v, dO (bh, S, d), lse and dd = rowsum(dO * O) (bh, S) float32.
int heat_flash_bwd_dq(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* dd, void* dq, int64_t bh, int s, int d, int bf16, float scale, int causal,
                      void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_DISPATCH(bf16, d, return (dq_launch<T, D>(q, k, v, dout, lse, dd, dq, bh, s, d, scale, causal,
                                                       static_cast<cudaStream_t>(stream))));
}

// dk, dv (bh, S, d) from the same inputs.
int heat_flash_bwd_dkv(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* dd, void* dk, void* dv, int64_t bh, int s, int d, int bf16, float scale,
                       int causal, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_DISPATCH(bf16, d, return (dkv_launch<T, D>(q, k, v, dout, lse, dd, dk, dv, bh, s, d, scale, causal,
                                                        static_cast<cudaStream_t>(stream))));
}

const char* heat_flash_strerror(int code) {
  if (code == kErrUnsupportedD) return "the flash-attention kernels take 1 <= d <= 128";
  if (code == kErrSharedMemory) return "the flash-attention tiles need more shared memory than this card gives a block";
  if (code == kErrBadShape) return "bad shape: batch*heads*ceil(S/64) must fit a 31-bit grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
