// KMeans E-step kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of heat_tpu/ops/kmeans_kernels.py:
//   assign   <- _assign_kernel   (l.67, via _fused_assign_impl l.84):
//               per-row argmin label and min d^2
//   em_stats <- _em_stats_kernel (l.111, via _fused_em_stats_impl l.161):
//               one Lloyd E+M sweep, per-cluster sums (k, d) and counts (k,)
// Both compute d2 = (|x|^2 + |c|^2) - 2 x.c in float32, clamp it at 0 and
// THEN take the argmin (lowest index wins a tie), as the TPU kernels do.
// |x|^2 and |c|^2 are float32 FFMA sums in column order.  The (n, k)
// distance matrix never exists in device memory.
//
// Bound on an H100 SXM at the BASELINE shape (n = 1e8, d = 32, k = 64):
// reading X once is 12.8 GB in float32 (3.82 ms at 3.35 TB/s; 4.06 ms with
// assign's labels and d^2) and 6.4 GB in bfloat16 (1.91 ms; 2.15 ms).  The
// products x.c are 2nkd = 4.1e11 FLOP: 6.1 ms on the CUDA cores' FFMA (67
// TFLOP/s), more than reading X.  On the tensor cores as
// split TF32 (below) they are 3 x 4.1e11 FLOP in float32, 2.5 ms at 495
// TFLOP/s TF32, and 2 x 4.1e11 in bfloat16, 1.7 ms.  So on this card the
// least time for an f32-accurate assignment is set by the bytes, and the
// design streams rows through shared memory while the tensor cores work:
//   * split TF32 ("3xTF32").  TF32 keeps 10 mantissa bits: one TF32
//     product moves d^2 by ~2^-11 of |x||c| and breaks the tolerances
//     (chip_smoke.py's D2_RTOL, TIE_RTOL; tests/test_torch_kmeans_split.py
//     shows it on the CPU).  So x = x_hi + x_lo and c = c_hi + c_lo, each
//     part rounded to TF32 (as cvt.rna rounds), and x.c = x_lo.c_hi +
//     x_hi.c_lo + x_hi.c_hi, in that order a k-step of 8 columns, into
//     float32 accumulators: about 2^-21 of |x||c|.  bfloat16 x is exact in
//     TF32 (x_lo = 0), so its instances take two products;
//   * a warp owns 32-row tiles (two m16 tiles) and walks the centres 64 at
//     a time.  Its x fragments (mma.sync's m16n8k8 A layout) are read from
//     the tile and split in registers once a k-step.  Where the centres'
//     hi and lo parts fit in shared memory beside em_stats' slices (k <=
//     256 / 126 / 48 at d <= 32 / 64 / 128 in float32, 263 / 128 / 63 in
//     bfloat16), the products are wgmma m64n64k8: the warpgroup's four
//     warps give their m16 tiles as A from registers, B is a 64-centre
//     chunk of c_hi or c_lo read by descriptor, and a k-step's A is split
//     while the step before multiplies.  Past that k the centres stay
//     float32 in mma.sync fragment order (a lane's B is one 8-byte load),
//     are split as they are loaded, and mma.sync m16n8k8 takes the
//     products.  Both kernels take the same path at every (k, d, dtype).
//     wgmma is the faster where it fits: at the main shape on an H100,
//     assign takes about 9 ms in float32 and 6.7 in bfloat16 with
//     mma.sync's products, 6 and 4.6 with wgmma's
//     (scripts/kmeans_probe.py's mma_sync variant, in turns);
//   * the epilogue reads the accumulators in place: each lane clamps and
//     keeps the least d^2 of its rows g and g + 8 (g = lane / 4) over its
//     columns, in ascending centre order; the quad reduces by
//     __shfl_xor_sync, the lower index winning equal values; then lane i
//     takes row i, so labels and d^2 are written coalesced and em_stats'
//     fold finds a row's label in the lane of the row.  Pad centres (to 64
//     under wgmma, to 8 under mma.sync) have |c|^2 = +inf, so their d^2 is
//     +inf and never wins;
//   * rows reach shared memory through a ring of 1-3 tiles a warp, filled
//     by 16-byte cp.async (rows past n zero-filled) while the tensor cores
//     work on the tile before.  Where d is not 32, 64 or 128, or x is off
//     16-byte alignment, float32 rows take 4-byte cp.async and bfloat16
//     rows element loads, into the same tiles: the same bits.  Tiles stay
//     in the storage type (bfloat16 is widened in the split) at a row
//     stride of DP plus 16 bytes, which puts a fragment read's 32 lanes on
//     32 banks;
//   * blocks are persistent (grid-stride over warp tiles, grid_cap), and
//     configure() picks the warps a block and ring stages for the most
//     resident warps an SM, then the most row copies in flight, from the
//     occupancy the runtime reports for the shared memory each needs.
// Largest k that launches (227 KB of shared memory; a k past it raises):
//   assign   float32 1720 / 856 / 416 at d = 32 / 64 / 128, bfloat16
//            1736 / 872 / 432;
//   em_stats float32 862 / 428 / 208, bfloat16 869 / 436 / 216.
//
// em_stats is deterministic.  The TPU kernel carried one accumulator across
// its sequential grid; here blocks run in parallel, so each WARP adds its own
// rows, in row order, into a private (k, DP) slice of shared memory; a block
// merges its warps in warp order into its slot of a (grid, k, d) scratch;
// a second kernel sums the slots in block order (in float64, counts in
// int64).  No float atomics anywhere, so sums repeat bit for bit run to run
// on one device.  Rows at index >= n are never read.
//
// em_stats runs assign's distance pass (the same assign_tile, so its labels
// are assign's to the bit) and then folds the tile into the warp's slice
// (fold_runs), lane t holding columns t + 32c: a tile of one label is summed
// in registers and added once; at d <= 32 a tile of few labels and many
// runs (a blob that two centres split) label by label from registers; else
// run by run, a run of one label summed in registers and added where it
// ends.  So a row costs a shared load and an add a column, and the slice's
// read-modify-writes fall to one a label or a run of a tile.  A cluster's
// rows are added in row order in every case.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kErrUnsupportedD = -1;
constexpr int kErrSharedMemory = -2;
constexpr int kErrBadGrid = -3;

constexpr int kRows = 32;      // rows of a warp's tile: two m16 tiles, one row a lane after the epilogue
constexpr int kChunk = 8;      // n8 tiles of centres a pass over a tile holds in accumulators
constexpr int kMaxStages = 3;  // row tiles in a warp's ring

// Residency counter, off unless heat_kmeans_residency turns it on: each
// warp of assign or em_stats counts itself live on its SM (%smid) from its
// first statement to its last, and each SM keeps the most warps it held at
// once.  Off, it costs a warp two calls and two loads of the flag.  It is
// out of line so that it leaves the kernels' register allocation as it is
// without it.
constexpr int kProbeSms = 1024;
__device__ int probe_on;
__device__ int probe_live[kProbeSms], probe_peak[kProbeSms];
__device__ __noinline__ void count_resident(bool enter) {
  if (*static_cast<volatile int*>(&probe_on) && (threadIdx.x & 31) == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(sm));
    if (enter)
      atomicMax(probe_peak + sm, atomicAdd(probe_live + sm, 1) + 1);
    else
      atomicSub(probe_live + sm, 1);
  }
}

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

__host__ __device__ constexpr int round8(int k) { return (k + 7) & ~7; }
__host__ __device__ constexpr int round64(int k) { return (k + 63) & ~63; }
// centres held in shared memory: a multiple of 64 for wgmma (whole chunks), of 8 for mma.sync
__host__ __device__ constexpr int padded_k(int k, bool wg) { return wg ? round64(k) : round8(k); }

// row stride of a ring tile in elements of the storage type: DP and 16 bytes
__host__ __device__ constexpr int row_stride(int dp, int tsize) { return dp + 16 / tsize; }

// rows of [r0, r0 + cap) that lie below n
__device__ __forceinline__ int rows_left(int64_t n, int64_t r0, int cap) {
  const int64_t left = n - r0;
  return left <= 0 ? 0 : (left < cap ? int(left) : cap);
}

// Shared memory of one block, in bytes:
//   centers (kc, DP): wgmma's B, TF32 hi and lo parts, or mma.sync's float32 fragments |
//   |c|^2 (kc) | ring (warps, stages, 32, row_stride) of T
//   [em only] per-warp sums (warps, k, DP) | per-warp counts (warps, k) int
size_t smem_bytes(int k, int dp, int tsize, int warps, int stages, bool em, bool wg) {
  const size_t kc = padded_k(k, wg);
  size_t b = (kc * dp * (wg ? 2 : 1) + kc) * 4 + size_t(warps) * stages * kRows * row_stride(dp, tsize) * tsize;
  if (em) b += (size_t(warps) * k * dp + size_t(warps) * k) * 4;
  return b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait for the oldest of `stages` groups in flight
__device__ __forceinline__ void cp_async_wait_oldest(int stages) {
  if (stages >= 3)
    cp_async_wait<2>();
  else if (stages == 2)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// v = hi + lo, each rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero: cvt.rna's rounding of a finite value, by integer ops on
// the bits); v - hi is exact in float32
__device__ __forceinline__ uint32_t to_tf32(float v) { return (__float_as_uint(v) + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

// c += a b: a 16 x 8 TF32 (row-major fragment), b 8 x 8 TF32 (column-major), c float32.
// Not volatile: it touches no memory, so the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma's descriptor of a K-major B operand without swizzle: 8 x 16-byte
// core matrices of 8 centres x 4 TF32 columns, the two column halves of a
// k-step 128 bytes apart (leading offset), centre octets 256 apart (stride)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return uint64_t((addr & 0x3ffff) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}
// d (+)= a b over a warpgroup: a 64 x 8 TF32 from registers (16 rows a warp,
// mma.sync's A fragment), b 8 x 64 TF32 by descriptor, d float32 in m16n8
// fragments of the warp's 16 rows (d[nt] holds n8 tile nt).  acc = 0: d = a b.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kChunk][4], const uint32_t (&a)[4], uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
        "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),
        "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep a register's value where it is until here: wgmma reads and writes
// its registers after the instruction that names them
template <int N, typename R>
__device__ __forceinline__ void hold(R (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void hold(float (&d)[kChunk][4]) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+f"(d[i][q])::"memory");
}

// Load the centres into cs, zero-padded to kc = padded_k(k) rows and DP
// columns, |c|^2 into cc (+inf for a pad centre), and zero the ring (its
// columns d..DP-1 must stay 0: they meet the zero pad of the centres).
// wgmma (WG): for 64-centre chunk ch, k-step s and part p (hi, lo), a 2 KB
// block ((ch KS + s) 2 + p) of wg_desc's layout.  mma.sync: float32 in
// fragment order, float2 e for n8 tile e / (64 KS), k-step s and lane (g,
// t) = (lane / 4, lane % 4) holding B's (b0, b1) = centre 8 tile + g at
// columns 8s + t and 8s + t + 4, split as they are loaded.
template <int DP, bool WG>
__device__ __forceinline__ void load_centers(float* cs, float* cc, uint32_t* ring, int ring_words,
                                             const float* __restrict__ centers, int k, int d) {
  constexpr int KS = DP / 8;
  const int kc = padded_k(k, WG);
  for (int e = threadIdx.x; e < kc * DP; e += blockDim.x) {
    if constexpr (WG) {
      const int j = e / DP, t = e % DP;
      uint32_t hi, lo;
      split_tf32((j < k && t < d) ? centers[size_t(j) * d + t] : 0.f, hi, lo);
      const int w = ((j >> 6) * KS + (t >> 3)) * 1024 + ((j >> 3) & 7) * 64 + ((t >> 2) & 1) * 32 + (j & 7) * 4 +
                    (t & 3);
      reinterpret_cast<uint32_t*>(cs)[w] = hi;
      reinterpret_cast<uint32_t*>(cs)[w + 512] = lo;
    } else {
      const int q = e & 1, ln = (e >> 1) & 31, rest = e >> 6, s = rest % KS, tile = rest / KS;
      const int j = tile * 8 + (ln >> 2), t = s * 8 + q * 4 + (ln & 3);
      cs[e] = (j < k && t < d) ? centers[size_t(j) * d + t] : 0.f;
    }
  }
  for (int j = threadIdx.x; j < kc; j += blockDim.x) {
    float s = 0.f;
    if (j < k)
      for (int t = 0; t < d; ++t) s = fmaf(centers[size_t(j) * d + t], centers[size_t(j) * d + t], s);
    cc[j] = j < k ? s : __int_as_float(0x7f800000);  // +inf: a pad centre never wins
  }
  for (int e = threadIdx.x; e < ring_words; e += blockDim.x) ring[e] = 0u;
  if constexpr (WG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // B is read by wgmma
  __syncthreads();
}

// Copy rows [r0, r0 + nr) of x into the tile st (32 rows, stride
// row_stride); rows past nr are zero.  vec (d == DP, x 16-byte aligned):
// 16-byte cp.async; else float32 by 4-byte cp.async and bfloat16 by the
// lanes, element by element, columns >= d untouched.
template <typename T, int DP>
__device__ __forceinline__ void copy_tile(T* st, const T* __restrict__ x, int64_t r0, int nr, int d, bool vec,
                                          int lane) {
  constexpr int XS = row_stride(DP, sizeof(T));
  if (vec) {  // lane copies row lane / VPR + m RS, columns (lane % VPR) V.., for each m
    constexpr int V = 16 / sizeof(T), VPR = DP / V, RS = 32 / VPR;
    const T* src = x + r0 * DP + lane * V;
    const uint32_t dst = smem_u32(st + (lane / VPR) * XS + (lane % VPR) * V);
    const int left = nr - lane / VPR;
#pragma unroll
    for (int m = 0; m < kRows / RS; ++m) {
      const bool ok = m * RS < left;
      cp_async_16(dst + m * RS * XS * int(sizeof(T)), ok ? src + m * 32 * V : x, ok);
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int e = lane; e < kRows * d; e += 32) {
      const int r = e / d, c = e - r * d;
      const bool ok = r < nr;
      cp_async_4(smem_u32(st + r * XS + c), x + (ok ? (r0 + r) * d + c : 0), ok);
    }
  } else {
    for (int e = lane; e < kRows * d; e += 32) {
      const int r = e / d, c = e - r * d;
      st[r * XS + c] = r < nr ? x[(r0 + r) * d + c] : __float2bfloat16(0.f);
    }
  }
}

// The A fragments of k-step s (columns 8s..8s+7) of the tile's two m16
// tiles, split: hi[mt], lo[mt] (lo is not read for bfloat16, exact in TF32)
template <typename T, int DP>
__device__ __forceinline__ void load_a(const T* st, int s, int g, int t, uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
  constexpr int XS = row_stride(DP, sizeof(T));
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const T* a = st + (16 * mt + g) * XS + 8 * s + t;
    const float v[4] = {to_f32(a[0]), to_f32(a[8 * XS]), to_f32(a[4]), to_f32(a[8 * XS + 4])};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (sizeof(T) == 4)
        split_tf32(v[q], hi[mt][q], lo[mt][q]);
      else
        hi[mt][q] = __float_as_uint(v[q]);
    }
  }
}

// x.c of the tile's 32 rows and the 64 centres of n8 tiles tile[0..7], by
// mma.sync: the centres' float32 fragments are split as they are loaded.
template <typename T, int DP>
__device__ __forceinline__ void products_mma(const T* st, const float* cs, const int (&tile)[kChunk], int lane,
                                             float (&acc)[2][kChunk][4]) {
  constexpr int KS = DP / 8;
  const float2* cs2 = reinterpret_cast<const float2*>(cs);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t ahi[2][4], alo[2][4];
    load_a<T, DP>(st, s, lane >> 2, lane & 3, ahi, alo);
#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt) {
      const float2 b = cs2[(tile[nt] * KS + s) * 32 + lane];
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b.x, bh0, bl0);
      split_tf32(b.y, bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if constexpr (sizeof(T) == 4) mma_tf32(acc[mt][nt], alo[mt], bh0, bh1);
        mma_tf32(acc[mt][nt], ahi[mt], bl0, bl1);
        mma_tf32(acc[mt][nt], ahi[mt], bh0, bh1);
      }
    }
  }
}

// The same for 64-centre chunk ch by wgmma: the warpgroup's 4 warps give
// their tiles' m16 tile mt as one m64 A, the chunk's hi and lo parts are
// B.  A k-step's fragments are split into one of two buffers while the
// products of the step before run.
template <typename T, int DP>
__device__ __forceinline__ void products_wgmma(const T* st, uint32_t cs_addr, int ch, int lane,
                                               float (&acc)[2][kChunk][4]) {
  constexpr int KS = DP / 8;
  constexpr bool kSplitX = sizeof(T) == 4;
  uint32_t ahi[2][2][4], alo[2][2][4];  // [buffer][mt][register]
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int b = s & 1;
    if (s >= 2) {
      wgmma_wait<1>();  // the products of step s - 2 are done with buffer b
      hold(ahi[b][0]), hold(ahi[b][1]), hold(alo[b][0]), hold(alo[b][1]);
    }
    load_a<T, DP>(st, s, lane >> 2, lane & 3, ahi[b], alo[b]);
    wgmma_fence();
    const uint32_t blk = cs_addr + (ch * KS + s) * 4096;
    const uint64_t bh = wg_desc(blk), bl = wg_desc(blk + 2048);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if constexpr (kSplitX) wgmma_tf32(acc[mt], alo[b][mt], bh, s > 0);
      wgmma_tf32(acc[mt], ahi[b][mt], bl, s > 0 || kSplitX);
      wgmma_tf32(acc[mt], ahi[b][mt], bh, 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  hold(acc[0]), hold(acc[1]);
#pragma unroll
  for (int b = 0; b < 2; ++b) hold(ahi[b][0]), hold(ahi[b][1]), hold(alo[b][0]), hold(alo[b][1]);
}

// The distance pass over one tile st: lane i gets row i's clamped min d^2
// (best) and its lowest-index argmin (bi) over the k centres (kc padded).
// WG: the products by wgmma (the whole warpgroup calls this together),
// else by mma.sync.
template <typename T, int DP, bool WG>
__device__ __forceinline__ void assign_tile(const T* st, const float* cs, const float* cc, int kc, int lane,
                                            float& best_out, int& bi_out) {
  constexpr int XS = row_stride(DP, sizeof(T));
  const int g = lane >> 2, t = lane & 3;
  // |x|^2 of row `lane`, an FFMA sum in column order, read 16 bytes at a time
  float xx = 0.f;
  {
    const uint4* row = reinterpret_cast<const uint4*>(st + lane * XS);
    constexpr int V = Vec16<T>::N;
#pragma unroll
    for (int q = 0; q < DP / V; ++q) {
      float f[V];
      Vec16<T>::unpack(row[q], f);
#pragma unroll
      for (int i = 0; i < V; ++i) xx = fmaf(f[i], f[i], xx);
    }
  }
  float xr[2][2], best[2][2];  // [m16 tile][h]: row 16 mt + 8 h + g
  int bi[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xr[mt][h] = __shfl_sync(0xffffffffu, xx, 16 * mt + 8 * h + g);
      best[mt][h] = __int_as_float(0x7f800000);  // +inf
      bi[mt][h] = 0;
    }
  // Centres go 64 at a time.  For mma.sync a chunk past the last n8 tile
  // reads the last tile again: its products are those of the tile already
  // taken, to the bit, so under the strict < they never win, and no branch
  // cuts the unrolled products or epilogue.  wgmma's centres are padded to
  // whole chunks.
  const int last = (kc >> 3) - 1;
  for (int c0 = 0; c0 < kc; c0 += 8 * kChunk) {
    int tile[kChunk];
#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt) tile[nt] = WG ? (c0 >> 3) + nt : min((c0 >> 3) + nt, last);
    float acc[2][kChunk][4];
    if constexpr (WG)
      products_wgmma<T, DP>(st, smem_u32(cs), c0 >> 6, lane, acc);
    else
      products_mma<T, DP>(st, cs, tile, lane, acc);
    // lane (g, t) holds rows g, g + 8 of each m16 tile at centres 2t, 2t + 1 of each n8 tile
#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt) {
      const int j = 8 * tile[nt] + 2 * t;
      const float2 cj = *reinterpret_cast<const float2*>(cc + j);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = fmaxf(fmaf(-2.f, acc[mt][nt][2 * h], xr[mt][h] + cj.x), 0.f);
          if (v0 < best[mt][h]) {
            best[mt][h] = v0;
            bi[mt][h] = j;
          }
          const float v1 = fmaxf(fmaf(-2.f, acc[mt][nt][2 * h + 1], xr[mt][h] + cj.y), 0.f);
          if (v1 < best[mt][h]) {
            best[mt][h] = v1;
            bi[mt][h] = j + 1;
          }
        }
    }
  }
  // the quad's least value, the lower index on equal values; then lane i takes row i
  const int src = (lane & 7) << 2, mine = lane >> 3;
  best_out = 0.f;
  bi_out = 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[mt][h], off);
        const int oj = __shfl_xor_sync(0xffffffffu, bi[mt][h], off);
        if (ob < best[mt][h] || (ob == best[mt][h] && oj < bi[mt][h])) {
          best[mt][h] = ob;
          bi[mt][h] = oj;
        }
      }
      const float vb = __shfl_sync(0xffffffffu, best[mt][h], src);
      const int vj = __shfl_sync(0xffffffffu, bi[mt][h], src);
      if (2 * mt + h == mine) {
        best_out = vb;
        bi_out = vj;
      }
    }
}

// Run body(tile, r0, nr) over this warp's tiles of 32 rows (tile w, w +
// warps on the grid, ...), each copied into the warp's ring of `stages`
// tiles: stages - 1 copies stay in flight ahead of the tile in use.  The
// four warps of a warpgroup go round the loop together (wgmma needs them
// all): a warp whose tile lies past n runs the body with nr = 0.
template <typename T, int DP, typename Body>
__device__ __forceinline__ void for_each_tile(const T* __restrict__ x, int64_t n, int d, bool vec, int stages,
                                              T* ring, int lane, Body body) {
  constexpr int TILE = kRows * row_stride(DP, sizeof(T));
  const int warps = blockDim.x >> 5;
  const int64_t tiles = (n + kRows - 1) / kRows, step = int64_t(gridDim.x) * warps;
  const int64_t first = int64_t(blockIdx.x) * warps + (threadIdx.x >> 5);
  for (int s = 0; s + 1 < stages; ++s) {
    const int64_t tl = first + s * step;
    if (tl < tiles) copy_tile<T, DP>(ring + s * TILE, x, tl * kRows, rows_left(n, tl * kRows, kRows), d, vec, lane);
    cp_async_commit();
  }
  int slot = 0;
  for (int64_t tl = first; tl - (threadIdx.x >> 5 & 3) < tiles; tl += step) {  // warpgroup-uniform
    const int64_t ahead = tl + int64_t(stages - 1) * step;
    const int fill = slot == 0 ? stages - 1 : slot - 1;  // the stage the last tile used
    if (ahead < tiles)
      copy_tile<T, DP>(ring + fill * TILE, x, ahead * kRows, rows_left(n, ahead * kRows, kRows), d, vec, lane);
    cp_async_commit();
    cp_async_wait_oldest(stages);
    __syncwarp();
    body(ring + slot * TILE, tl * kRows, rows_left(n, tl * kRows, kRows));
    __syncwarp();  // the stage is refilled next
    slot = slot + 1 == stages ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

template <typename T, int DP, bool WG>
__global__ void __launch_bounds__(256) assign_kernel(const T* __restrict__ x, const float* __restrict__ centers,
                                                     int64_t n, int k, int d, bool vec, int stages,
                                                     int* __restrict__ labels, float* __restrict__ d2out) {
  count_resident(true);
  extern __shared__ float4 smem4[];
  constexpr int TILE = kRows * row_stride(DP, sizeof(T));
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, kc = padded_k(k, WG);
  float* cs = reinterpret_cast<float*>(smem4);
  float* cc = cs + kc * DP * (WG ? 2 : 1);
  T* ring = reinterpret_cast<T*>(cc + kc);
  load_centers<DP, WG>(cs, cc, reinterpret_cast<uint32_t*>(ring), warps * stages * TILE * int(sizeof(T)) / 4, centers,
                   k, d);
  for_each_tile<T, DP>(x, n, d, vec, stages, ring + warp * stages * TILE, lane,
                       [&](const T* st, int64_t r0, int nr) {
                         float best;
                         int bi;
                         assign_tile<T, DP, WG>(st, cs, cc, kc, lane, best, bi);
                         if (lane < nr) {
                           labels[r0 + lane] = bi;
                           d2out[r0 + lane] = best;
                         }
                       });
  count_resident(false);
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

// Fold the tile's rows [0, nr) into the warp's sums ws (k, DP) and counts
// wc (k), in row order; lane i holds row i's label bi.  Lane t sums columns
// t + 32c in registers and adds each sum to the slice once, so the slice's
// read-modify-writes, whose latency chains one to the next, fall from one a
// row to one a label or a run of the tile.  A cluster's rows are added in
// row order, by whichever of three ways the tile takes (the choice depends
// on the labels only):
//   * one label over all 32 rows: their sum, added once;
//   * at d <= 32, few labels against many runs (a blob that two centres
//     split): each label's rows summed from registers, added once each;
//   * else run by run: a run of rows with one label ends where the
//     tile's next row has another label or there is none, and is added
//     where it ends.  The rows' values are read U at a time ahead of their
//     adds (an add's stores would keep later loads behind them).
// Columns d..DP-1 of the tile are 0, so their sums are too.
template <typename T, int DP>
__device__ __forceinline__ void fold_runs(const T* st, int bi, int nr, int lane, float* ws, int* wc) {
  constexpr int XS = row_stride(DP, sizeof(T)), C = DP / 32, U = C >= 4 ? 2 : 8 / C;
  const int rows_n = min(kRows, nr);  // warp-uniform, >= 1
  const T* rows = st + lane;
  const int next = __shfl_down_sync(0xffffffffu, bi, 1);
  const unsigned ends = __ballot_sync(0xffffffffu, lane < rows_n && (lane + 1 == rows_n || bi != next));
  const unsigned peers = __match_any_sync(0xffffffffu, lane < rows_n ? bi : -1);
  const unsigned leaders = __ballot_sync(0xffffffffu, lane < rows_n && (peers & ((1u << lane) - 1u)) == 0);
  const int labels = __popc(leaders), runs = __popc(ends);  // warp-uniform
  float sum[C];
#pragma unroll
  for (int c = 0; c < C; ++c) sum[c] = 0.f;
  if (rows_n == 32 && labels == 1) {  // every lane holds the label
#pragma unroll
    for (int r = 0; r < 32; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) sum[c] += to_f32(rows[r * XS + 32 * c]);
    flush_sum<DP, C>(ws, wc, bi, sum, 32, lane);
    return;
  }
  if constexpr (C == 1) {
    // about 4 instructions a row and label against a read-modify-write's
    // latency (~60 cycles) a run
    if (31 * labels <= 24 + 15 * runs) {
      float xv[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) xv[r] = to_f32(rows[r * XS]);
      for (unsigned left = leaders; left; left &= left - 1u) {
        const int first = __ffs(left) - 1;
        const unsigned mine = __shfl_sync(0xffffffffu, peers, first);
#pragma unroll
        for (int r = 0; r < 32; ++r)
          if ((mine >> r) & 1u) sum[0] += xv[r];
        flush_sum<DP, C>(ws, wc, __shfl_sync(0xffffffffu, bi, first), sum, __popc(mine), lane);
      }
      return;
    }
  }
  int start = 0;  // the open run's first row
#pragma unroll
  for (int r0 = 0; r0 < 32; r0 += U) {
    float xv[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < C; ++c) xv[u][c] = to_f32(rows[(r0 + u) * XS + 32 * c]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) sum[c] += xv[u][c];
      const int r = r0 + u;
      if ((ends >> r) & 1u) {  // warp-uniform: the run ends at this row
        flush_sum<DP, C>(ws, wc, __shfl_sync(0xffffffffu, bi, r), sum, r + 1 - start, lane);
        start = r + 1;
      }
    }
  }
}

template <typename T, int DP, bool WG>
__global__ void __launch_bounds__(256) em_stats_kernel(const T* __restrict__ x, const float* __restrict__ centers,
                                                       int64_t n, int k, int d, bool vec, int stages,
                                                       float* __restrict__ psums, int* __restrict__ pcounts) {
  count_resident(true);
  extern __shared__ float4 smem4[];
  constexpr int TILE = kRows * row_stride(DP, sizeof(T));
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, kc = padded_k(k, WG);
  float* cs = reinterpret_cast<float*>(smem4);
  float* cc = cs + kc * DP * (WG ? 2 : 1);
  T* ring = reinterpret_cast<T*>(cc + kc);
  float* wsum = reinterpret_cast<float*>(ring + warps * stages * TILE);
  int* wcnt = reinterpret_cast<int*>(wsum + warps * k * DP);
  for (int e = threadIdx.x; e < warps * k * DP; e += blockDim.x) wsum[e] = 0.f;
  for (int e = threadIdx.x; e < warps * k; e += blockDim.x) wcnt[e] = 0;
  load_centers<DP, WG>(cs, cc, reinterpret_cast<uint32_t*>(ring), warps * stages * TILE * int(sizeof(T)) / 4, centers,
                   k, d);  // syncs the block
  float* ws = wsum + warp * k * DP;
  int* wc = wcnt + warp * k;
  for_each_tile<T, DP>(x, n, d, vec, stages, ring + warp * stages * TILE, lane,
                       [&](const T* st, int64_t, int nr) {
                         float best;
                         int bi;
                         assign_tile<T, DP, WG>(st, cs, cc, kc, lane, best, bi);
                         if (nr > 0) fold_runs<T, DP>(st, bi, nr, lane, ws, wc);
                       });
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
  count_resident(false);
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
  bool wg;  // products by wgmma, else by mma.sync
  int warps;
  int stages;
  int blocks_per_sm;
  size_t smem;
  int grid_cap;  // resident blocks on the whole card
};

// wgmma's centres (hi and lo parts: twice mma.sync's bytes) are taken where
// em_stats, the larger of the two kernels, still fits a warpgroup with one
// ring stage.  Both kernels decide alike, so at every (k, d, dtype) they
// take the same products and em_stats' labels are assign's.
bool use_wgmma(int k, int dp, int tsize, int max_smem) {
  return smem_bytes(k, dp, tsize, 4, 1, true, true) <= size_t(max_smem);
}

// Pick the warps a block and the ring's stages that keep the most warps
// resident on an SM, then the most row copies in flight (resident warps x
// (stages - 1)), as the runtime's occupancy calculator reports them.
// (em_stats' per-warp slices fill shared memory: at the main shape on an
// H100, 8 warps an SM with two copies ahead, scripts/kmeans_probe.py's
// copies_first variant, ran no faster than 12 (float32) or 16 (bfloat16)
// without a copy ahead, and about 12% slower in bfloat16.)  wgmma takes
// whole warpgroups: 4 or 8 warps.
template <typename Kernel>
int configure(Kernel kern, int k, int dp, int tsize, bool em, bool wg, Config* cfg) {
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  int best_flight = -1, best_resident = 0;
  cfg->wg = wg;
  cfg->warps = 0;
  for (int w = 8; w >= (wg ? 4 : 1); w >>= 1) {
    for (int s = kMaxStages; s >= 1; --s) {
      const size_t bytes = smem_bytes(k, dp, tsize, w, s, em, wg);
      if (bytes > size_t(max_smem)) continue;
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
      int blocks = 0;
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, w * 32, bytes);
      if (err != cudaSuccess) return int(err);
      const int resident = blocks * w, flight = resident * (s - 1);
      if (resident > 0 && (resident > best_resident || (resident == best_resident && flight > best_flight))) {
        best_flight = flight;
        best_resident = resident;
        cfg->warps = w;
        cfg->stages = s;
        cfg->blocks_per_sm = blocks;
        cfg->smem = bytes;
        cfg->grid_cap = blocks * sms;
      }
    }
  }
  if (cfg->warps == 0) return kErrSharedMemory;
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(cfg->smem)));
}

// The launch of assign (EM false) or em_stats for k centres.
template <typename T, int DP, bool EM>
int configure_for(int k, Config* cfg) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return int(err);
  constexpr int ts = sizeof(T);
  if (use_wgmma(k, DP, ts, max_smem))
    return EM ? configure(em_stats_kernel<T, DP, true>, k, DP, ts, true, true, cfg)
              : configure(assign_kernel<T, DP, true>, k, DP, ts, false, true, cfg);
  return EM ? configure(em_stats_kernel<T, DP, false>, k, DP, ts, true, false, cfg)
            : configure(assign_kernel<T, DP, false>, k, DP, ts, false, false, cfg);
}

int64_t tiles_of(int64_t n, const Config& cfg) {
  const int64_t rows = int64_t(cfg.warps) * kRows;
  return (n + rows - 1) / rows;
}

// rows are whole 16-byte vectors: d == DP and x 16-byte aligned
template <int DP>
bool vec_ok(const void* x, int d) {
  return d == DP && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

template <typename T, int DP>
int assign_launch(const void* x, const float* c, int64_t n, int k, int d, int* labels, float* d2,
                  cudaStream_t stream) {
  Config cfg;
  const int err = configure_for<T, DP, false>(k, &cfg);
  if (err != 0) return err;
  const int64_t grid = tiles_of(n, cfg) < cfg.grid_cap ? tiles_of(n, cfg) : cfg.grid_cap;
  if (grid == 0) return 0;
  auto kern = cfg.wg ? assign_kernel<T, DP, true> : assign_kernel<T, DP, false>;
  kern<<<int(grid), cfg.warps * 32, cfg.smem, stream>>>(static_cast<const T*>(x), c, n, k, d, vec_ok<DP>(x, d),
                                                        cfg.stages, labels, d2);
  return int(cudaGetLastError());
}

template <typename T, int DP>
int em_grid(int64_t n, int k) {
  Config cfg;
  const int err = configure_for<T, DP, true>(k, &cfg);
  if (err != 0) return err > 0 ? -1000 - err : err;
  const int64_t tiles = tiles_of(n, cfg);
  return int(tiles < 1 ? 1 : (tiles < cfg.grid_cap ? tiles : cfg.grid_cap));
}

template <typename T, int DP>
int em_launch(const void* x, const float* c, int64_t n, int k, int d, int grid, float* psums, int* pcounts,
              float* sums, float* counts, cudaStream_t stream) {
  Config cfg;
  const int err = configure_for<T, DP, true>(k, &cfg);
  if (err != 0) return err;
  if (grid < 1) return kErrBadGrid;
  auto kern = cfg.wg ? em_stats_kernel<T, DP, true> : em_stats_kernel<T, DP, false>;
  kern<<<grid, cfg.warps * 32, cfg.smem, stream>>>(static_cast<const T*>(x), c, n, k, d, vec_ok<DP>(x, d),
                                                   cfg.stages, psums, pcounts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int total = k * d + k;
  em_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(psums, pcounts, grid, k, k * d, sums, counts);
  return int(cudaGetLastError());
}

// out: wgmma (1) or mma.sync (0), warps a block, ring stages, resident
// blocks an SM, shared bytes a block
template <typename T, int DP>
int launch_config(int k, bool em, int* out) {
  Config cfg;
  const int err = em ? configure_for<T, DP, true>(k, &cfg) : configure_for<T, DP, false>(k, &cfg);
  if (err != 0) return err;
  out[0] = cfg.wg;
  out[1] = cfg.warps;
  out[2] = cfg.stages;
  out[3] = cfg.blocks_per_sm;
  out[4] = int(cfg.smem);
  return 0;
}

// Dispatch on the storage type and on d: tiles are padded to DP = 32, 64
// or 128 columns.
#define HEAT_KMEANS_DISPATCH(BF16, D, CALL)                                     \
  do {                                                                          \
    if (BF16) {                                                                 \
      if ((D) <= 32) { using T = __nv_bfloat16; constexpr int DP = 32; CALL; }  \
      if ((D) <= 64) { using T = __nv_bfloat16; constexpr int DP = 64; CALL; }  \
      if ((D) <= 128) { using T = __nv_bfloat16; constexpr int DP = 128; CALL; } \
    } else {                                                                    \
      if ((D) <= 32) { using T = float; constexpr int DP = 32; CALL; }          \
      if ((D) <= 64) { using T = float; constexpr int DP = 64; CALL; }          \
      if ((D) <= 128) { using T = float; constexpr int DP = 128; CALL; }        \
    }                                                                           \
    return kErrUnsupportedD;                                                    \
  } while (0)

}  // namespace

extern "C" {

// Labels (int32) and clamped min d^2 (float32) of rows [0, n) of x (n, d).
int heat_kmeans_assign(int device, const void* x, const float* centers, int64_t n, int k, int d, int bf16,
                       int* labels, float* d2, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_KMEANS_DISPATCH(bf16, d, return (assign_launch<T, DP>(x, centers, n, k, d, labels, d2,
                                                              static_cast<cudaStream_t>(stream))));
}

// Number of row-tile partitions (>= 1) em_stats uses for n rows; the caller
// allocates (grid, k, d) float32 and (grid, k) int32 scratch.  < 0: error.
int heat_kmeans_em_grid(int device, int64_t n, int k, int d, int bf16) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return -1000 - int(guard.error());
  HEAT_KMEANS_DISPATCH(bf16, d, return (em_grid<T, DP>(n, k)));
}

// Per-cluster sums (k, d) and counts (k,) over rows [0, n) of x.
int heat_kmeans_em_stats(int device, const void* x, const float* centers, int64_t n, int k, int d, int bf16,
                         int grid, float* psums, int* pcounts, float* sums, float* counts, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_KMEANS_DISPATCH(bf16, d, return (em_launch<T, DP>(x, centers, n, k, d, grid, psums, pcounts, sums,
                                                          counts, static_cast<cudaStream_t>(stream))));
}

// The launch assign (em = 0) or em_stats (em = 1) makes for k centres of
// width d: out[5] = wgmma (1) or mma.sync (0), warps a block, ring stages,
// resident blocks an SM, shared bytes a block.
int heat_kmeans_launch_config(int device, int k, int d, int bf16, int em, int* out) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_KMEANS_DISPATCH(bf16, d, return (launch_config<T, DP>(k, em != 0, out)));
}

// Turn the residency counter on (on = 1) or off, after the device is idle;
// either way, peak[i] (i < sms, at most 1024) gets the most warps of assign
// and em_stats live at once on SM i since the last call, which clears them.
int heat_kmeans_residency(int device, int on, int* peak, int sms) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  static const int zeros[kProbeSms] = {};
  const size_t bytes = size_t(sms < kProbeSms ? sms : kProbeSms) * sizeof(int);
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(peak, probe_peak, bytes);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(probe_peak, zeros, sizeof zeros);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(probe_on, &on, sizeof on);
  return int(err);
}

const char* heat_kmeans_strerror(int code) {
  if (code == kErrUnsupportedD) return "d > 128 is not supported by the kmeans kernels";
  if (code == kErrSharedMemory) return "k * d too large for the kernels' shared-memory layout";
  if (code == kErrBadGrid) return "grid must be >= 1";
  if (code <= -1000) return cudaGetErrorString(static_cast<cudaError_t>(-1000 - code));
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
