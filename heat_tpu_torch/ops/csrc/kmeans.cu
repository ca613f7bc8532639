// KMeans E-step kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of heat_tpu/ops/kmeans_kernels.py:
//   assign   <- _assign_kernel   (l.67):  per-row argmin label and min d^2
//   em_stats <- _em_stats_kernel (l.111): one Lloyd E+M sweep, per-cluster
//                                         sums (k, d) and counts (k,)
// Both compute d2 = (|x|^2 + |c|^2) - 2 x.c in float32 on the CUDA cores,
// clamp it at 0 and THEN take the argmin (lowest index wins a tie), as the
// TPU kernels do.  The (n, k) distance matrix never exists in device memory.
//
// Bound on an H100 SXM: the distance pass is 2*n*k*d FLOP; at the
// BASELINE shape (n=1e8, d=32, k=64) that is 4.1e11 FLOP, about 6 ms at the
// 67 TFLOP/s float32 rate, while reading X is 12.8 GB float32 (3.8 ms at
// 3.35 TB/s) or 6.4 GB bfloat16.  So the kernels are compute-bound and the
// design spends its effort on the inner product loop:
//   * each warp stages a slab of 32*RPT rows into shared memory with 16-byte
//     coalesced loads (x stays in its storage type in device memory and is
//     widened to float32 here), at a padded stride of DP+1 floats so that
//     the per-row reads below are free of bank conflicts;
//   * each lane then holds RPT whole rows in registers and walks the centers
//     four at a time: every 16-byte broadcast read of a center from shared
//     memory feeds 4*RPT independent FMAs;
//   * the centers and |c|^2 sit in shared memory, zero-padded to DP columns,
//     for the block's whole life; blocks loop over row tiles (grid-stride).
// TF32 tensor cores (and wgmma) are deliberately not used: they keep ~10
// bits of mantissa and change which center wins a near-tie.
//
// em_stats is deterministic.  The TPU kernel carried one accumulator across
// its sequential grid; here blocks run in parallel, so each WARP adds its own
// rows, in row order, into a private (k, DP) slice of shared memory; a block
// merges its warps in warp order into its slot of a (grid, k, d) scratch;
// a second kernel sums the slots in block order (in float64, counts in
// int64).  No float atomics anywhere, so sums repeat bit for bit run to run
// on one device.  Rows at index >= n are never read.
//
// em_stats runs assign's distance pass (the same stage_rows and
// assign_rows, so its labels are assign's to the bit) and then folds the
// slab into the warp's slice (fold_runs), 32 rows at a time, lane t holding
// columns t + 32c: a group of one label is summed in registers and added
// once; at d <= 32 a group of few labels and many runs (a blob that two
// centres split) label by label from registers; else run by run, a run of
// one label summed in registers and added where it ends.  So a row costs a
// shared load and an add a column, and the slice's read-modify-writes,
// whose latency chained one row to the next, fall to one a label or a run
// of a group: on the BASELINE blobs, which hold each cluster in contiguous
// rows, one a group; on rows in random order still about one a row.
// A cluster's rows are added in row order in every case.  The per-warp
// slices stay: registers (199-255 a thread), not the slices' shared
// memory, bound the warps an SM (measured on an NVIDIA H100 80GB HBM3 at
// 700 W: PERF.md §6), and em_reduce takes microseconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kErrUnsupportedD = -1;
constexpr int kErrSharedMemory = -2;
constexpr int kErrBadGrid = -3;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16-byte vector of the storage type, widened to float32
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&o)[4]) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&o)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      o[2 * q] = f.x;
      o[2 * q + 1] = f.y;
    }
  }
};

__host__ __device__ inline int round4(int k) { return (k + 3) & ~3; }

// rows of [r0, r0 + cap) that lie below n
__device__ __forceinline__ int rows_left(int64_t n, int64_t r0, int cap) {
  const int64_t left = n - r0;
  return left <= 0 ? 0 : (left < cap ? int(left) : cap);
}

// Shared memory of one block, in bytes:
//   centers (k4, DP) | |c|^2 (k4) | per-warp stage (warps, 32*RPT, DP+1)
//   [em only] per-warp sums (warps, k, DP) | per-warp counts (warps, k) int
__host__ __device__ inline size_t smem_bytes(int k, int dp, int rpt, int warps, bool em) {
  size_t k4 = round4(k);
  size_t f = k4 * dp + k4 + size_t(warps) * 32 * rpt * (dp + 1);
  if (em) f += size_t(warps) * k * dp + size_t(warps) * k;
  return f * 4;
}

// Load the centers (zero-padded to k4 rows and DP columns) and |c|^2, and
// zero the stage (its pad columns d..DP-1 must stay 0: they meet the zero
// pad of the centers, and 0 * garbage could be NaN).
template <int DP>
__device__ __forceinline__ void load_centers(float* cs, float* cc, float* stage, int stage_floats,
                                             const float* __restrict__ centers, int k, int d) {
  const int k4 = round4(k);
  for (int e = threadIdx.x; e < k4 * DP; e += blockDim.x) {
    const int j = e / DP, t = e % DP;
    cs[e] = (j < k && t < d) ? centers[size_t(j) * d + t] : 0.f;
  }
  for (int e = threadIdx.x; e < stage_floats; e += blockDim.x) stage[e] = 0.f;
  __syncthreads();
  for (int j = threadIdx.x; j < k4; j += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < d; ++t) s = fmaf(cs[j * DP + t], cs[j * DP + t], s);
    cc[j] = s;
  }
  __syncthreads();
}

// Stage rows [r0, r0 + nr) of x into this warp's slab (stride DP + 1).
template <typename T, int DP, int RPT>
__device__ __forceinline__ void stage_rows(float* st, const T* __restrict__ x, int64_t r0, int nr, int d,
                                           bool vec, int lane) {
  constexpr int XS = DP + 1;
  constexpr int ROWS = 32 * RPT;
  if (vec) {  // d == DP and x is 16-byte aligned: rows are whole vectors
    constexpr int V = Vec16<T>::N;
    constexpr int VPR = DP / V;
    const uint4* src = reinterpret_cast<const uint4*>(x + r0 * DP);
    const int nv = nr * VPR;
    uint4 u[ROWS * VPR / 32];
#pragma unroll
    for (int m = 0; m < ROWS * VPR / 32; ++m) {
      const int v = lane + 32 * m;
      if (v < nv) u[m] = __ldg(src + v);
    }
#pragma unroll
    for (int m = 0; m < ROWS * VPR / 32; ++m) {
      const int v = lane + 32 * m;
      if (v < nv) {
        float f[V];
        Vec16<T>::unpack(u[m], f);
        const int r = v / VPR, t = (v % VPR) * V;
#pragma unroll
        for (int q = 0; q < V; ++q) st[r * XS + t + q] = f[q];
      }
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < nr; ++r) {
      const T* row = x + (r0 + r) * int64_t(d);
      for (int t = lane; t < d; t += 32) st[r * XS + t] = to_f32(row[t]);
    }
  }
}

// Lane `lane` assigns slab rows lane, lane + 32, ... (RPT of them): best is
// the clamped min d^2 and bi its lowest-index argmin.
template <int DP, int RPT>
__device__ __forceinline__ void assign_rows(const float* st, const float* cs, const float* cc, int k, int lane,
                                            float (&best)[RPT], int (&bi)[RPT]) {
  constexpr int XS = DP + 1;
  float xr[RPT][DP];
  float xx[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < DP; ++t) {
      const float v = st[(lane + 32 * i) * XS + t];
      xr[i][t] = v;
      s = fmaf(v, v, s);
    }
    xx[i] = s;
    best[i] = __int_as_float(0x7f800000);  // +inf
    bi[i] = 0;
  }
  const float4* c4 = reinterpret_cast<const float4*>(cs);
  for (int j0 = 0; j0 < k; j0 += 4) {
    float acc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll
    for (int t = 0; t < DP; t += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 c = c4[((j0 + q) * DP + t) / 4];  // same address on every lane: broadcast
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][q] = fmaf(xr[i][t], c.x, acc[i][q]);
          acc[i][q] = fmaf(xr[i][t + 1], c.y, acc[i][q]);
          acc[i][q] = fmaf(xr[i][t + 2], c.z, acc[i][q]);
          acc[i][q] = fmaf(xr[i][t + 3], c.w, acc[i][q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      if (j < k) {
        const float cj = cc[j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float v = fmaxf((xx[i] + cj) - 2.f * acc[i][q], 0.f);
          if (v < best[i]) {
            best[i] = v;
            bi[i] = j;
          }
        }
      }
    }
  }
}

template <typename T, int DP, int RPT>
__global__ void __launch_bounds__(256) assign_kernel(const T* __restrict__ x, const float* __restrict__ centers,
                                                     int64_t n, int k, int d, bool vec, int* __restrict__ labels,
                                                     float* __restrict__ d2out) {
  extern __shared__ float4 smem4[];
  constexpr int ROWS = 32 * RPT, XS = DP + 1;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cs = reinterpret_cast<float*>(smem4);
  float* cc = cs + round4(k) * DP;
  float* stage = cc + round4(k);
  load_centers<DP>(cs, cc, stage, warps * ROWS * XS, centers, k, d);
  float* st = stage + warp * ROWS * XS;
  const int64_t tile = int64_t(warps) * ROWS;
  for (int64_t base = int64_t(blockIdx.x) * tile; base < n; base += int64_t(gridDim.x) * tile) {
    const int64_t r0 = base + int64_t(warp) * ROWS;
    const int nr = rows_left(n, r0, ROWS);
    if (nr == 0) continue;  // warp-uniform
    stage_rows<T, DP, RPT>(st, x, r0, nr, d, vec, lane);
    __syncwarp();
    float best[RPT];
    int bi[RPT];
    assign_rows<DP, RPT>(st, cs, cc, k, lane, best, bi);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = lane + 32 * i;
      if (r < nr) {
        labels[r0 + r] = bi[i];
        d2out[r0 + r] = best[i];
      }
    }
    __syncwarp();  // the slab is restaged next tile
  }
}

// Add a sum of rows of label lab, count of them, to the warp's slice:
// lane t's columns t + 32c of ws (k, DP), and lane 0 the count of wc (k).
template <int DP, int C>
__device__ __forceinline__ void flush_sum(float* ws, int* wc, int lab, float (&sum)[C], int count, int lane) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ws[lab * DP + lane + 32 * c] += sum[c];
    sum[c] = 0.f;
  }
  if (lane == 0) atomicAdd(wc + lab, count);  // integer: the same sum in any order
}

// Fold the slab's rows [0, nr) into the warp's sums ws (k, DP) and counts
// wc (k), in row order, a group of 32 rows at a time; bi holds each lane's
// labels (rows lane + 32i).  Lane t sums columns t + 32c in registers and
// adds each sum to the slice once, so the slice's read-modify-writes, whose
// latency chains one to the next, fall from one a row to one a label or a
// run of a group.  A cluster's rows are added in row order, by whichever
// of three ways the group takes (the choice depends on the labels only):
//   * one label over all 32 rows: their sum, added once;
//   * at d <= 32, few labels against many runs (a blob that two centres
//     split): each label's rows summed from registers, added once each;
//   * else run by run: a run of rows with one label ends where the
//     group's next row has another label or there is none, and is added
//     where it ends.  The rows' values are read U at a time ahead of their
//     adds (an add's stores would keep later loads behind them).
// Columns d..DP-1 of the stage are 0, so their sums are too.
template <int DP, int RPT>
__device__ __forceinline__ void fold_runs(const float* st, const int (&bi)[RPT], int nr, int lane, float* ws,
                                          int* wc) {
  constexpr int XS = DP + 1, C = DP / 32, U = C >= 4 ? 2 : 8 / C;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int rows_i = min(32, nr - 32 * i);  // warp-uniform
    if (rows_i <= 0) break;
    const float* rows = st + 32 * i * XS + lane;
    const int next = __shfl_down_sync(0xffffffffu, bi[i], 1);
    const unsigned ends = __ballot_sync(0xffffffffu, lane < rows_i && (lane + 1 == rows_i || bi[i] != next));
    const unsigned peers = __match_any_sync(0xffffffffu, lane < rows_i ? bi[i] : -1);
    const unsigned leaders = __ballot_sync(0xffffffffu, lane < rows_i && (peers & ((1u << lane) - 1u)) == 0);
    const int labels = __popc(leaders), runs = __popc(ends);  // warp-uniform
    float sum[C];
#pragma unroll
    for (int c = 0; c < C; ++c) sum[c] = 0.f;
    if (rows_i == 32 && labels == 1) {  // every lane holds the label
#pragma unroll
      for (int r = 0; r < 32; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) sum[c] += rows[r * XS + 32 * c];
      flush_sum<DP, C>(ws, wc, bi[i], sum, 32, lane);
      continue;
    }
    if constexpr (C == 1) {
      // about 4 instructions a row and label against a read-modify-write's
      // latency (~60 cycles) a run
      if (31 * labels <= 24 + 15 * runs) {
        float xv[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) xv[r] = rows[r * XS];
        for (unsigned left = leaders; left; left &= left - 1u) {
          const int first = __ffs(left) - 1;
          const unsigned mine = __shfl_sync(0xffffffffu, peers, first);
#pragma unroll
          for (int r = 0; r < 32; ++r)
            if ((mine >> r) & 1u) sum[0] += xv[r];
          flush_sum<DP, C>(ws, wc, __shfl_sync(0xffffffffu, bi[i], first), sum, __popc(mine), lane);
        }
        continue;
      }
    }
    int start = 0;  // the open run's first row
#pragma unroll
    for (int r0 = 0; r0 < 32; r0 += U) {
      float xv[U][C];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < C; ++c) xv[u][c] = rows[(r0 + u) * XS + 32 * c];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < C; ++c) sum[c] += xv[u][c];
        const int r = r0 + u;
        if ((ends >> r) & 1u) {  // warp-uniform: the run ends at this row
          flush_sum<DP, C>(ws, wc, __shfl_sync(0xffffffffu, bi[i], r), sum, r + 1 - start, lane);
          start = r + 1;
        }
      }
    }
  }
}

template <typename T, int DP, int RPT>
__global__ void __launch_bounds__(256) em_stats_kernel(const T* __restrict__ x, const float* __restrict__ centers,
                                                       int64_t n, int k, int d, bool vec,
                                                       float* __restrict__ psums, int* __restrict__ pcounts) {
  extern __shared__ float4 smem4[];
  constexpr int ROWS = 32 * RPT, XS = DP + 1;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cs = reinterpret_cast<float*>(smem4);
  float* cc = cs + round4(k) * DP;
  float* stage = cc + round4(k);
  float* wsum = stage + warps * ROWS * XS;
  int* wcnt = reinterpret_cast<int*>(wsum + warps * k * DP);
  for (int e = threadIdx.x; e < warps * k * DP; e += blockDim.x) wsum[e] = 0.f;
  for (int e = threadIdx.x; e < warps * k; e += blockDim.x) wcnt[e] = 0;
  load_centers<DP>(cs, cc, stage, warps * ROWS * XS, centers, k, d);  // syncs the block
  float* st = stage + warp * ROWS * XS;
  float* ws = wsum + warp * k * DP;
  int* wc = wcnt + warp * k;
  const int64_t tile = int64_t(warps) * ROWS;
  for (int64_t base = int64_t(blockIdx.x) * tile; base < n; base += int64_t(gridDim.x) * tile) {
    const int64_t r0 = base + int64_t(warp) * ROWS;
    const int nr = rows_left(n, r0, ROWS);
    if (nr == 0) continue;  // warp-uniform
    stage_rows<T, DP, RPT>(st, x, r0, nr, d, vec, lane);
    __syncwarp();
    float best[RPT];
    int bi[RPT];
    assign_rows<DP, RPT>(st, cs, cc, k, lane, best, bi);
    fold_runs<DP, RPT>(st, bi, nr, lane, ws, wc);
    __syncwarp();  // the slab is restaged next tile
  }
  __syncthreads();
  // merge the warps in warp order into this block's slot
  const int kd = k * d;
  for (int e = threadIdx.x; e < kd; e += blockDim.x) {
    const int j = e / d, t = e - j * d;
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += wsum[(w * k + j) * DP + t];
    psums[int64_t(blockIdx.x) * kd + e] = s;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    int c = 0;
    for (int w = 0; w < warps; ++w) c += wcnt[w * k + j];
    pcounts[int64_t(blockIdx.x) * k + j] = c;
  }
}

// Sum the blocks' slots in block order.
__global__ void em_reduce_kernel(const float* __restrict__ psums, const int* __restrict__ pcounts, int grid,
                                 int k, int kd, float* __restrict__ sums, float* __restrict__ counts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < kd) {
    double s = 0.0;
    for (int b = 0; b < grid; ++b) s += psums[int64_t(b) * kd + e];
    sums[e] = float(s);
  } else if (e < kd + k) {
    const int j = e - kd;
    long long c = 0;
    for (int b = 0; b < grid; ++b) c += pcounts[int64_t(b) * k + j];
    counts[j] = float(c);
  }
}

struct Config {
  int warps;
  size_t smem;
  int grid_cap;  // resident blocks on the whole card
};

// Pick the warps per block that keep the most warps resident per SM.
template <typename Kernel>
int configure(Kernel kern, int k, int dp, int rpt, bool em, Config* cfg) {
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  int best_resident = 0;
  cfg->warps = 0;
  for (int w = 8; w >= 1; w >>= 1) {
    const size_t bytes = smem_bytes(k, dp, rpt, w, em);
    if (bytes > size_t(max_smem)) continue;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    int blocks = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, w * 32, bytes);
    if (err != cudaSuccess) return int(err);
    if (blocks * w > best_resident) {
      best_resident = blocks * w;
      cfg->warps = w;
      cfg->smem = bytes;
      cfg->grid_cap = blocks * sms;
    }
  }
  if (cfg->warps == 0) return kErrSharedMemory;
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(cfg->smem)));
}

int64_t tiles_of(int64_t n, const Config& cfg, int rpt) {
  const int64_t rows = int64_t(cfg.warps) * 32 * rpt;
  return (n + rows - 1) / rows;
}

template <typename T, int DP, int RPT>
int assign_launch(const void* x, const float* c, int64_t n, int k, int d, int* labels, float* d2,
                  cudaStream_t stream) {
  Config cfg;
  const int err = configure(assign_kernel<T, DP, RPT>, k, DP, RPT, false, &cfg);
  if (err != 0) return err;
  const int64_t grid = tiles_of(n, cfg, RPT) < cfg.grid_cap ? tiles_of(n, cfg, RPT) : cfg.grid_cap;
  if (grid == 0) return 0;
  const bool vec = d == DP && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  assign_kernel<T, DP, RPT><<<int(grid), cfg.warps * 32, cfg.smem, stream>>>(
      static_cast<const T*>(x), c, n, k, d, vec, labels, d2);
  return int(cudaGetLastError());
}

template <typename T, int DP, int RPT>
int em_grid(int64_t n, int k) {
  Config cfg;
  const int err = configure(em_stats_kernel<T, DP, RPT>, k, DP, RPT, true, &cfg);
  if (err != 0) return err > 0 ? -1000 - err : err;
  const int64_t tiles = tiles_of(n, cfg, RPT);
  return int(tiles < 1 ? 1 : (tiles < cfg.grid_cap ? tiles : cfg.grid_cap));
}

template <typename T, int DP, int RPT>
int em_launch(const void* x, const float* c, int64_t n, int k, int d, int grid, float* psums, int* pcounts,
              float* sums, float* counts, cudaStream_t stream) {
  Config cfg;
  const int err = configure(em_stats_kernel<T, DP, RPT>, k, DP, RPT, true, &cfg);
  if (err != 0) return err;
  if (grid < 1) return kErrBadGrid;
  const bool vec = d == DP && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  em_stats_kernel<T, DP, RPT><<<grid, cfg.warps * 32, cfg.smem, stream>>>(
      static_cast<const T*>(x), c, n, k, d, vec, psums, pcounts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int total = k * d + k;
  em_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(psums, pcounts, grid, k, k * d, sums, counts);
  return int(cudaGetLastError());
}

// Dispatch on the storage type and on d: rows are held in registers padded
// to DP columns, two rows a lane up to DP=64 and one at DP=128.
#define HEAT_KMEANS_DISPATCH(BF16, D, CALL)                                            \
  do {                                                                                 \
    if (BF16) {                                                                        \
      if ((D) <= 32) { using T = __nv_bfloat16; constexpr int DP = 32, RPT = 2; CALL; } \
      if ((D) <= 64) { using T = __nv_bfloat16; constexpr int DP = 64, RPT = 2; CALL; } \
      if ((D) <= 128) { using T = __nv_bfloat16; constexpr int DP = 128, RPT = 1; CALL; } \
    } else {                                                                           \
      if ((D) <= 32) { using T = float; constexpr int DP = 32, RPT = 2; CALL; }        \
      if ((D) <= 64) { using T = float; constexpr int DP = 64, RPT = 2; CALL; }        \
      if ((D) <= 128) { using T = float; constexpr int DP = 128, RPT = 1; CALL; }      \
    }                                                                                  \
    return kErrUnsupportedD;                                                           \
  } while (0)

}  // namespace

extern "C" {

// Labels (int32) and clamped min d^2 (float32) of rows [0, n) of x (n, d).
int heat_kmeans_assign(int device, const void* x, const float* centers, int64_t n, int k, int d, int bf16,
                       int* labels, float* d2, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_KMEANS_DISPATCH(bf16, d, return (assign_launch<T, DP, RPT>(x, centers, n, k, d, labels, d2,
                                                                   static_cast<cudaStream_t>(stream))));
}

// Number of row-tile partitions (>= 1) em_stats uses for n rows; the caller
// allocates (grid, k, d) float32 and (grid, k) int32 scratch.  < 0: error.
int heat_kmeans_em_grid(int device, int64_t n, int k, int d, int bf16) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return -1000 - int(guard.error());
  HEAT_KMEANS_DISPATCH(bf16, d, return (em_grid<T, DP, RPT>(n, k)));
}

// Per-cluster sums (k, d) and counts (k,) over rows [0, n) of x.
int heat_kmeans_em_stats(int device, const void* x, const float* centers, int64_t n, int k, int d, int bf16,
                         int grid, float* psums, int* pcounts, float* sums, float* counts, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_KMEANS_DISPATCH(bf16, d, return (em_launch<T, DP, RPT>(x, centers, n, k, d, grid, psums, pcounts, sums,
                                                               counts, static_cast<cudaStream_t>(stream))));
}

const char* heat_kmeans_strerror(int code) {
  if (code == kErrUnsupportedD) return "d > 128 is not supported by the kmeans kernels";
  if (code == kErrSharedMemory) return "k * d too large for the kernels' shared-memory layout";
  if (code == kErrBadGrid) return "grid must be >= 1";
  if (code <= -1000) return cudaGetErrorString(static_cast<cudaError_t>(-1000 - code));
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
