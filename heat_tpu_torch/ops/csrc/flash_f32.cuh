// The float32 flash-attention bodies on Hopper's CUDA cores (sm_90a): the
// forward, dq and dk/dv.
//
// Included by flash_attention.cu inside its anonymous namespace, after
// flash_bwd_tc.cuh, whose helpers it calls (smem_u32, cp_async_16,
// cp_async_4 and the commit/wait pair), and after the mask policies
// (StaticMask, PosMask) and BQ, BK, PAD, TS, kNoMass.  It has no includes of
// its own.
//
// flash_fwd_f32_kernel<D, VEC, Mask> is the forward (O and lse),
// flash_bwd_dq_f32_kernel<D, VEC, Mask> dq and flash_bwd_dkv_f32_kernel
// <D, VEC, Mask> dk and dv, for float32 storage in all three of their uses.
// They replace the Pallas TPU kernels
//   _flash_kernel (heat_tpu/ops/flash_attention.py:132) via _flash_fwd_impl
//     (l.479), _flash_bwd_dq_kernel (l.339) and _flash_bwd_dkv_kernel
//     (l.376) via _flash_bwd_impl (l.517): flash_fwd, flash_bwd_dq and
//     flash_bwd_dkv, under StaticMask;
//   _flash_gqa_fwd_impl (l.871) and _flash_gqa_bwd_impl (l.910): the same
//     bodies with K/V row bh / group and dk, dv summed over the group (l.924,
//     945): flash_gqa_fwd, flash_gqa_bwd_dq and flash_gqa_bwd_dkv, under
//     StaticMask;
//   _flash_pos_kernel (l.235), _flash_pos_bwd_dq_kernel (l.264) and
//     _flash_pos_bwd_dkv_kernel (l.298), via _flash_pos_fwd_impl (l.596) and
//     _flash_pos_bwd_impl (l.636): flash_pos_fwd, flash_pos_bwd_dq and
//     flash_pos_bwd_dkv, under PosMask.
// The arithmetic is the reference's, in full float32 (every product a
// float32 FFMA, no TF32): S = q.k summed over d in ascending order.  The
// forward takes S * scale (-inf where the mask drops the key), the online
// softmax over 64-key tiles (_online_update: P = exp(s - m) at the running
// maximum m of the tiles so far, 0 for a dropped key, never exp of -inf;
// l and O rescaled by exp(m_old - m)), O += P.V summed in ascending key
// order, and _finalize (O / max(l, 1e-30), lse = m + log(l) or -1e30 where
// l = 0).  The backward takes P = exp(S * scale - lse) with the product and
// the difference each rounded as the plain version rounds them (0 where
// the mask drops the key), dP = dO.v, dS = P * (dP - dd) * scale; then dq =
// dS.K, dv = P^T.dO and dk = dS^T.Q, each summed in ascending key or query
// order into one float32 accumulator, dk and dv over the group's query
// heads head by head and tile by tile.  exp is expf, not 2^x on
// ex2.approx: it keeps the plain version's P to the bit, and at <= 12
// instructions a (q, k) pair against 128 (forward), 192 (dq) and 256
// (dk/dv) FFMA it costs a few percent of the issue slots.  Nothing crosses
// blocks and there are no atomics, so runs repeat bit for bit, and the
// 16-byte and the element-wise loads fill the same tiles, so the sums do
// not depend on the load path.
//
// Bound on an H100 SXM (67 TFLOP/s float32 outside the tensor cores,
// 3.35 TB/s), causal, at 4 (forward), 6 (dq) and 8 (dk/dv) FLOP a live
// (q, k) pair and d: at (B*H, S, d) = (64, 1024, 64), the LM training
// step's attention, the forward is 8.6 GFLOP (0.128 ms) against 34 MB
// (0.010 ms), dq 12.9 GFLOP (0.192 ms) against 42.5 MB (0.013 ms) and
// dk/dv 17.2 GFLOP (0.256 ms) against 50.9 MB: compute-bound, so the
// design is about keeping the FMA pipes fed from shared memory.
// What the design does about it:
//   * blocks of 128 threads (4 warps).  Forward and dq: one block a (query
//     row, 64-query tile), looping over its live 64-key tiles; each thread
//     holds an 8 x 4 patch of S (and dP) (queries ty + 8i, keys tx + 16j,
//     with tx = thread % 16, ty = thread / 16) and 8 x 4 (D = 64) or 8 x 8
//     outputs of O or dq.  The forward keeps its 8 queries' running
//     maximum m, which the 16 lanes of a row reduce by __shfl_xor_sync each
//     tile, and each lane's own share of the running sum l, reduced across
//     the row once, at the end.  dk/dv: one
//     block a (K/V row, 32-key tile), looping over the group's query heads
//     and in each its live 64-query tiles; each thread holds a 4 x 4 patch
//     of S^T and dP^T (keys ty + 8i, queries tx + 16j) and 4 x 4 (or 4 x 8)
//     outputs of dk and of dv;
//   * every tile is row-major in shared memory, rows padded by 4 floats.
//     Products over d read float4 along d from both operands; products
//     over keys or queries read P, dS or P^T as float4 along their rows and
//     V, K, dO or Q as float4 along d.  A thread's rows tx + 16j at a row
//     stride of D + 4 floats put a quarter warp's 16-byte reads on distinct
//     banks; rows ty + 8i are read by at most two threads' worth of
//     addresses a warp (a broadcast); each float4 pair feeds 16 FFMA, 12
//     shared loads to 128 FFMA in S;
//   * P (forward), dS (dq) and P^T, dS^T (dk/dv) go through shared rows that
//     only the warp that writes them reads (its 16 queries, its 8 keys), so
//     they need __syncwarp and no block barrier; the forward's P has a tile
//     of its own, dq writes dS over the V tile of the current stage, after
//     one barrier;
//   * the streamed operand (K and V for the forward and dq; Q, dO, lse, dd
//     for dk/dv) sits in a ring of two stages, the next live tile filled by
//     cp.async while the current one is used: 16 bytes a thread where
//     d % 4 == 0 and every operand is 16-byte aligned (VEC), 4 bytes an
//     element otherwise, into the same tiles.  One block barrier a tile in
//     the forward and dk/dv, two in dq;
//   * shared memory: the forward 5 tiles of 64 rows and P (102 KB at
//     D = 64), dq 6 tiles of 64 rows (104 KB), dk/dv 2 of 32 keys, 4 of 64
//     queries and 2 of 32 x 64 (105 KB): two blocks (8 warps) an SM at
//     D = 64, one at D = 128.  32-key dk/dv blocks give the grouped grid 512
//     blocks at (64 -> 16, 1024, 64) and the multi-head one 2048;
//   * blocks go out heaviest causal tile first over every row; a tile that
//     the mask cuts is masked element by element, a full tile not at all;
//   * a PosMask block with no live pair (every key pad or after every
//     query) finds so in one parallel pass over the positions, writes its
//     outputs (O = 0 and lse = -1e30, dq = 0, dk = dv = 0) and returns
//     before it loads a tile;
//   * any d in [1, 128]: tiles are zero-padded to D = 64 or 128 columns and
//     rows past the end load as zeros, so S is never padded in memory.
// What holds them back: all three run at about half the FFMA rate (on an
// NVIDIA H100 80GB HBM3 at 700 W, (64, 1024, 64) causal: dq 0.37 ms, dk/dv
// 0.58 against bounds of 0.19 and 0.26; the forward's own time and what
// bounds it are in PERF.md §6), with 8 warps an SM to hide the shared
// loads' latency and the barriers, the forward's and dq's exp and row
// reductions between the products, a 4 x 4 register patch in dk/dv (8
// shared loads to 64 FFMA), and dq and dk/dv each recomputing S and dP.
// Variants of the backward tried on that card and not kept (PERF.md §6):
// 3 dk/dv blocks an SM with one stage (faster on the multi-head grid,
// slower on the grouped one, whose heaviest block then outlasts the
// rest), 32-query steps at 3 blocks an SM, dk/dv blocks that split S^T
// and dP^T between two groups of warps (4 x 4 or 8 x 4 patches, 32 or 64
// keys), another warp shape, fusing dq's two products into one loop, and
// the shared-memory carveout hint: none faster on both grids.

constexpr int kF32Threads = 128;  // a block: 4 warps
constexpr int kDkvKeys = 32;      // keys of a float32 dk/dv block
static_assert(kF32Threads == 2 * BQ && BQ == 64 && BK == 64 && kDkvKeys == 32,
              "the thread map: 16 x 8 threads over 64-row tiles, one thread a row of lse or dd");
template <int D>
constexpr int kF32MinBlocks = D == 64 ? 2 : 1;  // as shared memory allows

template <int D>
constexpr size_t fwd_f32_smem() {  // sq [BQ][D + PAD]; sk, sv [2][BK][D + PAD]; P [BQ][TS]
  return sizeof(float) * (5 * BQ * (D + PAD) + BQ * TS);
}
template <int D>
constexpr size_t dq_f32_smem() {  // sq, sdo [BQ][D + PAD]; sk, sv [2][BK][D + PAD]
  return sizeof(float) * 6 * BQ * (D + PAD);
}
// sk, sv [32][D + PAD]; sq, sdo [2][BQ][D + PAD]; P^T, dS^T [32][TS]; lse, dd [2][BQ]
template <int D>
constexpr size_t dkv_f32_smem() {
  return sizeof(float) * ((2 * kDkvKeys + 4 * BQ) * (D + PAD) + 2 * kDkvKeys * TS + 4 * BQ);
}

// component u of v, for a u the unrolled loops make a constant
__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Rows [r0, r0 + R) of a row-major (n, d) float32 matrix into the shared
// tile dst[R][D + PAD], asynchronously; rows >= n and columns >= d are zero
template <int R, int D, bool VEC>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ src, int r0, int n, int d) {
  constexpr int SD = D + PAD;
  if constexpr (VEC) {
    constexpr int C = D / 4, RS = kF32Threads / C;  // 16-byte chunks a row; rows a pass of the block
    static_assert(kF32Threads % C == 0 && R % RS == 0, "the passes must tile the rows");
    const int c = threadIdx.x % C, r1 = threadIdx.x / C;
    const float* from = src + int64_t(r0 + r1) * d + c * 4;
    const uint32_t to = smem_u32(dst + r1 * SD + c * 4);
#pragma unroll
    for (int i = 0; i < R / RS; ++i) {
      const bool valid = r0 + r1 + i * RS < n && c * 4 < d;
      cp_async_16(to + i * RS * SD * 4, valid ? from + int64_t(i * RS) * d : src, valid);
    }
  } else {
    for (int e = threadIdx.x; e < R * D; e += kF32Threads) {
      const int r = e / D, c = e % D;
      const bool valid = r0 + r < n && c < d;
      cp_async_4(smem_u32(dst + r * SD + c), valid ? src + int64_t(r0 + r) * d + c : src, valid);
    }
  }
}

// acc[p][i][j] += sum over c < D, ascending, of a[p][ty + 8i][c] *
// b[p][tx + 16j][c], for each of the P products: rows of row-major shared
// tiles of stride SD, float4 along c; the products of one step of c are
// issued together, so P * NI * 4 independent sums hide the FFMA latency
template <int D, int SD, int P, int NI>
__device__ __forceinline__ void dot_rows(float (&acc)[P][NI][4], const float* const (&a)[P],
                                         const float* const (&b)[P], int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 bv[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[p][j] = *reinterpret_cast<const float4*>(b[p] + (tx + 16 * j) * SD + c);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 av = *reinterpret_cast<const float4*>(a[p] + (ty + 8 * i) * SD + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& x = acc[p][i][j];
          x = fmaf(av.x, bv[p][j].x, x);
          x = fmaf(av.y, bv[p][j].y, x);
          x = fmaf(av.z, bv[p][j].z, x);
          x = fmaf(av.w, bv[p][j].w, x);
        }
      }
  }
}

// acc[p][i][g*4 + e] += sum over r < R, ascending, of a[p][ty + 8i][r] *
// b[p][r][g*64 + tx*4 + e], for each of the P products: a of stride TS (dS,
// P^T, dS^T), b of stride SD (K, dO, Q), float4 along r in a and along the
// columns in b
template <int R, int SD, int P, int NI, int NG>
__device__ __forceinline__ void mul_rows(float (&acc)[P][NI][NG * 4], const float* const (&a)[P],
                                         const float* const (&b)[P], int ty, int tx) {
#pragma unroll 2
  for (int r = 0; r < R; r += 4) {
    float4 av[P][NI];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < NI; ++i) av[p][i] = *reinterpret_cast<const float4*>(a[p] + (ty + 8 * i) * TS + r);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float4 bv = *reinterpret_cast<const float4*>(b[p] + (r + u) * SD + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const float x = lane_of(av[p][i], u);
            float* y = acc[p][i] + g * 4;
            y[0] = fmaf(x, bv.x, y[0]);
            y[1] = fmaf(x, bv.y, y[1]);
            y[2] = fmaf(x, bv.z, y[2]);
            y[3] = fmaf(x, bv.w, y[3]);
          }
        }
  }
}

// Rows r0 + ty + 8i (below n) of a row-major (n, d) float32 output from a
// thread's acc[i][g*4 + e] at columns g*64 + tx*4 + e: float4 with VEC
template <int NI, int NG, bool VEC>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ dst, const float (&acc)[NI][NG * 4], int r0, int n,
                                               int d, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = r0 + ty + 8 * i;
    if (row >= n) continue;
    float* out = dst + int64_t(row) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = g * 64 + tx * 4;
      if constexpr (VEC) {
        if (c < d)
          *reinterpret_cast<float4*>(out + c) =
              make_float4(acc[i][g * 4], acc[i][g * 4 + 1], acc[i][g * 4 + 2], acc[i][g * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) out[c + e] = acc[i][g * 4 + e];
      }
    }
  }
}

// Zeros into rows [r0, r0 + R) (below n) of a row-major (n, d) float32 output
template <int R>
__device__ __forceinline__ void zero_rows_f32(float* __restrict__ dst, int r0, int n, int d) {
  for (int e = threadIdx.x; e < R * d; e += kF32Threads)
    if (r0 + e / d < n) dst[int64_t(r0) * d + e] = 0.f;
}

// Does some key of the whole block see a query of the tile whose largest
// position is qmax (forward and dq), or some query see a key whose smallest
// position is kmin (dk/dv)?  Exactly what the tile-by-tile liveness finds over all the
// tiles, in one parallel pass over the positions, 1024 a round, stopping at
// the first live round.  StaticMask blocks always have a live tile.
__device__ __forceinline__ bool q_block_live(const StaticMask&, int) { return true; }
__device__ __forceinline__ bool q_block_live(const PosMask& m, int qmax) {
  if (!m.masked) return true;
  for (int base = 0; base < m.Sk; base += 8 * kF32Threads) {
    bool any = false;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = base + e * kF32Threads + int(threadIdx.x);
      if (j < m.Sk) {
        const int kp = m.kpos[j];
        any |= kp < m.s_valid && (!m.causal || kp <= qmax);
      }
    }
    if (__syncthreads_or(any)) return true;
  }
  return false;
}
__device__ __forceinline__ bool dkv_block_live(const StaticMask&, int2) { return true; }
__device__ __forceinline__ bool dkv_block_live(const PosMask& m, int2 keys) {
  if (!m.masked) return true;
  if (keys.x >= m.s_valid) return false;  // every key of the block is pad
  if (!m.causal) return m.Sq > 0;
  for (int base = 0; base < m.Sq; base += 8 * kF32Threads) {
    bool any = false;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = base + e * kF32Threads + int(threadIdx.x);
      if (i < m.Sq) any |= m.qpos[i] >= keys.x;
    }
    if (__syncthreads_or(any)) return true;
  }
  return false;
}

// (min, max) position of the keys [k0, k0 + 32) of a dk/dv block below the
// key rows, the same in every warp (one key a lane); as tile_span for the
// 64-row tiles
__device__ __forceinline__ int2 dkv_block_keys(const StaticMask&, int k0) { return make_int2(k0, k0 + kDkvKeys - 1); }
__device__ __forceinline__ int2 dkv_block_keys(const PosMask& m, int k0) {
  if (!m.masked) return make_int2(0, 0);
  const int r = k0 + int(threadIdx.x % 32);
  const int kp = r < m.Sk ? m.kpos[r] : 0;
  return make_int2(__reduce_min_sync(0xffffffffu, r < m.Sk ? kp : INT_MAX),
                   __reduce_max_sync(0xffffffffu, r < m.Sk ? kp : INT_MIN));
}

// P of one element, as the plain version takes it: exp(s * scale - lse),
// the product and the difference each rounded to float32
__device__ __forceinline__ float p_of(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}

// reductions over the 16 lanes that share a row (lanes differing in tx)
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

template <int D, bool VEC, typename Mask>
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks<D>)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         float* __restrict__ out, float* __restrict__ lse, int rows, int d, int group, float scale,
                         const Mask mask) {
  constexpr int SD = D + PAD, NG = D / 64;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + BQ * SD;      // [2][BK][SD]
  float* sv = sk + 2 * BK * SD;  // [2][BK][SD]
  float* sp = sv + 2 * BK * SD;  // P [BQ][TS]: a warp writes and reads its own rows ty + 8i only

  const int Sq = mask.q_rows(), Sk = mask.k_rows();
  const int nq = (Sq + BQ - 1) / BQ;
  const int iq = nq - 1 - int(blockIdx.x) / rows;  // heaviest causal tiles first, over every row
  const int bh = int(blockIdx.x) % rows;            // the query row; its K/V row is bh / group
  const int q0 = iq * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const int qmax = mask.query_bound(q0);
  if (!q_block_live(mask, qmax)) {  // no live pair: O = 0 and lse = -1e30, as _finalize writes
    zero_rows_f32<BQ>(out + int64_t(bh) * Sq * d, q0, Sq, d);
    if (threadIdx.x < BQ && q0 + int(threadIdx.x) < Sq) lse[int64_t(bh) * Sq + q0 + threadIdx.x] = kNoMass;
    return;
  }
  const int64_t kv_base = int64_t(bh / group) * Sk * d;
  k += kv_base;
  v += kv_base;
  const int nk = mask.key_end(iq);
  auto next_live = [&](int ik, int2& keys) {  // the same in every warp; keys: the tile's (min, max) position
    for (; ik < nk; ++ik) {
      keys = mask.fwd_tile_range(ik * BK);
      if (mask.fwd_block_live(keys, qmax)) break;
    }
    return ik;
  };
  auto load_kv = [&](int ik, int stage) {
    load_rows_f32<BK, D, VEC>(sk + stage * BK * SD, k, ik * BK, Sk, d);
    load_rows_f32<BK, D, VEC>(sv + stage * BK * SD, v, ik * BK, Sk, d);
  };

  load_rows_f32<BQ, D, VEC>(sq, q + int64_t(bh) * Sq * d, q0, Sq, d);
  int2 keys, next_keys;
  int ik = next_live(0, keys);
  if (ik < nk) load_kv(ik, 0);
  cp_async_commit();
  // this thread's rows q0 + ty + 8i: running maximum, the running sum of
  // this lane's P, position; rows past Sq compute on zeros and are not written
  float m[8], l[8];
  int qp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    qp[i] = mask.q_pos(q0 + ty + 8 * i);
  }
  const int2 span = mask.bwd_tile_range(q0);  // the block's query positions (min, max)
  float acc[1][8][NG * 4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) acc[0][i][j] = 0.f;

  for (int stage = 0; ik < nk; stage ^= 1) {
    const int k0 = ik * BK;
    const int nxt = next_live(ik + 1, next_keys);
    cp_async_wait<0>();  // tile ik (and, the first time, Q) has landed
    __syncthreads();     // ... for every thread, and every warp is done with the other stage
    if (nxt < nk) load_kv(nxt, stage ^ 1);
    cp_async_commit();
    const float* ks = sk + stage * BK * SD;
    const float* vs = sv + stage * BK * SD;
    float s[1][8][4] = {};
    dot_rows<D, SD, 1, 8>(s, {sq}, {ks}, ty, tx);  // S = Q K^T; element (q0 + ty + 8i, k0 + tx + 16j)
    // _masked_scores: S * scale, -inf where the mask drops the key
    if (k0 + BK <= Sk && mask.fwd_tile_full(keys, span)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[0][i][j] = __fmul_rn(s[0][i][j], scale);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const int kp = mask.k_pos(col);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[0][i][j] = mask.dead(qp[i], kp, col) ? -INFINITY : __fmul_rn(s[0][i][j], scale);
      }
    }
    // _online_update, row by row; P into this warp's own rows of the P tile
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float mx = fmaxf(fmaxf(s[0][i][0], s[0][i][1]), fmaxf(s[0][i][2], s[0][i][3]));
      const float m_new = fmaxf(m[i], row_max(mx));  // rows with no live key so far keep m = -inf
      const float safe = isfinite(m_new) ? m_new : 0.f;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = isfinite(s[0][i][j]) ? expf(__fsub_rn(s[0][i][j], safe)) : 0.f;
        sp[(ty + 8 * i) * TS + tx + 16 * j] = p;
        ps += p;
      }
      const float corr = isfinite(m[i]) ? expf(__fsub_rn(m[i], safe)) : 0.f;
      l[i] = l[i] * corr + ps;  // this lane's share of the row sum: summed over the row's lanes at the end
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NG * 4; ++j) acc[0][i][j] *= corr;
    }
    __syncwarp();
    mul_rows<BK, SD, 1, 8, NG>(acc, {sp}, {vs}, ty, tx);  // O += P V
    ik = nxt;
    keys = next_keys;
  }
  cp_async_wait<0>();  // no copy outlives the block, also where no tile was live
  // _finalize
  float den[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[i] = row_sum(l[i]);
    den[i] = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) acc[0][i][j] /= den[i];
  }
  store_rows_f32<8, NG, VEC>(out + int64_t(bh) * Sq * d, acc[0], q0, Sq, d, ty, tx);
  if (tx == 0) {
    lse += int64_t(bh) * Sq;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + ty + 8 * i;
      if (row < Sq) lse[row] = l[i] > 0.f ? (isfinite(m[i]) ? m[i] : 0.f) + logf(den[i]) : kNoMass;
    }
  }
}

template <int D, bool VEC, typename Mask>
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks<D>)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ dd, float* __restrict__ dq, int rows, int d, int group,
                            float scale, const Mask mask) {
  constexpr int SD = D + PAD, NG = D / 64;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + BQ * SD;
  float* sk = sdo + BQ * SD;     // [2][BK][SD]
  float* sv = sk + 2 * BK * SD;  // [2][BK][SD]; the current stage's holds dS [BQ][TS] once dP is taken

  const int Sq = mask.q_rows(), Sk = mask.k_rows();
  const int nq = (Sq + BQ - 1) / BQ;
  const int iq = nq - 1 - int(blockIdx.x) / rows;  // heaviest causal tiles first, over every row
  const int bh = int(blockIdx.x) % rows;            // the query row; its K/V row is bh / group
  const int q0 = iq * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const int qmax = mask.query_bound(q0);
  if (!q_block_live(mask, qmax)) {  // no live pair: dq = 0
    zero_rows_f32<BQ>(dq + int64_t(bh) * Sq * d, q0, Sq, d);
    return;
  }
  const int64_t kv_base = int64_t(bh / group) * Sk * d;
  k += kv_base;
  v += kv_base;
  const int nk = mask.key_end(iq);
  auto next_live = [&](int ik, int2& keys) {  // the same in every warp; keys: the tile's (min, max) position
    for (; ik < nk; ++ik) {
      keys = mask.fwd_tile_range(ik * BK);
      if (mask.fwd_block_live(keys, qmax)) break;
    }
    return ik;
  };
  auto load_kv = [&](int ik, int stage) {
    load_rows_f32<BK, D, VEC>(sk + stage * BK * SD, k, ik * BK, Sk, d);
    load_rows_f32<BK, D, VEC>(sv + stage * BK * SD, v, ik * BK, Sk, d);
  };

  load_rows_f32<BQ, D, VEC>(sq, q + int64_t(bh) * Sq * d, q0, Sq, d);
  load_rows_f32<BQ, D, VEC>(sdo, dout + int64_t(bh) * Sq * d, q0, Sq, d);
  int2 keys, next_keys;
  int ik = next_live(0, keys);
  if (ik < nk) load_kv(ik, 0);
  cp_async_commit();
  // this thread's rows q0 + ty + 8i: lse, dd and position; rows past Sq
  // compute on zeros (dS = 1 * (0 - 0) * scale) and are not written
  float lse_r[8], dd_r[8];
  int qp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty + 8 * i;
    lse_r[i] = row < Sq ? lse[int64_t(bh) * Sq + row] : 0.f;
    dd_r[i] = row < Sq ? dd[int64_t(bh) * Sq + row] : 0.f;
    qp[i] = mask.q_pos(row);
  }
  const int2 span = mask.bwd_tile_range(q0);  // the block's query positions (min, max)
  float acc[1][8][NG * 4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) acc[0][i][j] = 0.f;

  for (int stage = 0; ik < nk; stage ^= 1) {
    const int k0 = ik * BK;
    const int nxt = next_live(ik + 1, next_keys);
    cp_async_wait<0>();  // tile ik (and, the first time, Q and dO) has landed
    __syncthreads();     // ... for every thread, and every warp is done with the other stage
    if (nxt < nk) load_kv(nxt, stage ^ 1);
    cp_async_commit();
    const float* ks = sk + stage * BK * SD;
    float* vs = sv + stage * BK * SD;
    float dp[1][8][4] = {}, s[1][8][4] = {};
    dot_rows<D, SD, 1, 8>(dp, {sdo}, {vs}, ty, tx);  // dP = dO V^T
    __syncthreads();                                 // every warp is done with V: dS goes over it
    dot_rows<D, SD, 1, 8>(s, {sq}, {ks}, ty, tx);    // S = Q K^T
    // _recompute_p and dS = P (dP - dd) scale; element (q0 + ty + 8i, k0 + tx + 16j)
    if (k0 + BK <= Sk && mask.fwd_tile_full(keys, span)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[0][i][j] = p_of(s[0][i][j], scale, lse_r[i]) * (dp[0][i][j] - dd_r[i]) * scale;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const int kp = mask.k_pos(col);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = mask.dead(qp[i], kp, col) ? 0.f : p_of(s[0][i][j], scale, lse_r[i]);
          s[0][i][j] = p * (dp[0][i][j] - dd_r[i]) * scale;
        }
      }
    }
    // dS into this warp's own rows (ty + 8i) of the V stage; dQ += dS K
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) vs[(ty + 8 * i) * TS + tx + 16 * j] = s[0][i][j];
    __syncwarp();
    mul_rows<BK, SD, 1, 8, NG>(acc, {vs}, {ks}, ty, tx);
    ik = nxt;
    keys = next_keys;
  }
  cp_async_wait<0>();  // no copy outlives the block, also where no tile was live
  store_rows_f32<8, NG, VEC>(dq + int64_t(bh) * Sq * d, acc[0], q0, Sq, d, ty, tx);
}

template <int D, bool VEC, typename Mask>
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks<D>)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ dd, float* __restrict__ dk, float* __restrict__ dv, int rows,
                             int d, int group, float scale, const Mask mask) {
  constexpr int SD = D + PAD, NG = D / 64, NK = kDkvKeys;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + NK * SD;
  float* sq = sv + NK * SD;       // [2][BQ][SD]
  float* sdo = sq + 2 * BQ * SD;  // [2][BQ][SD]
  float* spt = sdo + 2 * BQ * SD;  // P^T [NK][TS]
  float* sdst = spt + NK * TS;     // dS^T [NK][TS]
  float* slse = sdst + NK * TS;    // [2][BQ]
  float* sdd = slse + 2 * BQ;      // [2][BQ]

  const int Sq = mask.q_rows(), Sk = mask.k_rows();
  const int ik = int(blockIdx.x) / rows;  // under causal the first key tiles have the most work: first
  const int bh = int(blockIdx.x) % rows;  // the K/V row; its query rows are bh * group + h
  const int k0 = ik * NK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t base = int64_t(bh) * Sk * d;

  const int2 keys = dkv_block_keys(mask, k0);  // the block's key positions (min, max)
  if (!dkv_block_live(mask, keys)) {          // no live pair: dk = dv = 0
    zero_rows_f32<NK>(dk + base, k0, Sk, d);
    zero_rows_f32<NK>(dv + base, k0, Sk, d);
    return;
  }
  // the items: each query head of the group, and in it the query tiles from
  // query_begin on, head by head; the live ones are those whose queries see
  // some key of this block
  const int nq = (Sq + BQ - 1) / BQ;
  const int qbegin = mask.query_begin(k0 / BK);
  const int per_head = nq - qbegin, items = group * per_head;
  auto next_live = [&](int it, int2& queries) {  // the same in every warp; queries: the tile's (min, max) position
    for (; it < items; ++it) {
      queries = mask.bwd_tile_range((qbegin + it % per_head) * BQ);
      if (mask.fwd_block_live(keys, queries.y)) break;
    }
    return it;
  };
  auto load_q = [&](int it, int stage) {
    const int64_t qrow = int64_t(bh) * group + it / per_head;
    const int q0 = (qbegin + it % per_head) * BQ;
    load_rows_f32<BQ, D, VEC>(sq + stage * BQ * SD, q + qrow * Sq * d, q0, Sq, d);
    load_rows_f32<BQ, D, VEC>(sdo + stage * BQ * SD, dout + qrow * Sq * d, q0, Sq, d);
    const int i = threadIdx.x % BQ, row = q0 + i;  // threads [0, BQ) read lse, [BQ, 2 BQ) dd
    const float* src = (threadIdx.x < BQ ? lse : dd) + qrow * Sq;
    cp_async_4(smem_u32((threadIdx.x < BQ ? slse : sdd) + stage * BQ + i), row < Sq ? src + row : src, row < Sq);
  };

  load_rows_f32<NK, D, VEC>(sk, k + base, k0, Sk, d);
  load_rows_f32<NK, D, VEC>(sv, v + base, k0, Sk, d);
  int2 queries, next_queries;
  int it = next_live(0, queries);
  if (it < items) load_q(it, 0);
  cp_async_commit();

  float dvk[2][4][NG * 4];  // dV, dK
  int kp[4];               // this thread's keys k0 + ty + 8i: positions
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kp[i] = mask.k_pos(k0 + ty + 8 * i);
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) dvk[0][i][j] = dvk[1][i][j] = 0.f;
  }

  for (int stage = 0; it < items; stage ^= 1) {
    const int q0 = (qbegin + it % per_head) * BQ;
    const int nxt = next_live(it + 1, next_queries);
    cp_async_wait<0>();  // item it (and, the first time, K and V) has landed
    __syncthreads();     // ... for every thread, and every warp is done with the other stage
    if (nxt < items) load_q(nxt, stage ^ 1);
    cp_async_commit();
    const float* qs = sq + stage * BQ * SD;
    const float* dos = sdo + stage * BQ * SD;
    const float* lse_s = slse + stage * BQ;
    const float* dd_s = sdd + stage * BQ;
    float sp[2][4][4] = {};  // S^T = K Q^T and dP^T = V dO^T
    dot_rows<D, SD, 2, 4>(sp, {sk, sv}, {qs, dos}, ty, tx);
    float(&st)[4][4] = sp[0];
    float(&dpt)[4][4] = sp[1];
    // P^T and dS^T = P^T (dP^T - dd) scale; element (key k0 + ty + 8i, query q0 + tx + 16j)
    const bool full = q0 + BQ <= Sq && k0 + NK <= Sk && mask.bwd_tile_full(queries, keys);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tx + 16 * j;
      const float lse_c = lse_s[tx + 16 * j], dd_c = dd_s[tx + 16 * j];
      const int qp = full ? 0 : mask.q_pos(row);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 8 * i;  // query rows past Sq and keys past Sk take part in nothing
        const bool dead = !full && (row >= Sq || mask.dead(qp, kp[i], key));
        const float p = dead ? 0.f : p_of(st[i][j], scale, lse_c);
        st[i][j] = p;
        dpt[i][j] = p * (dpt[i][j] - dd_c) * scale;
      }
    }
    // into this warp's own key rows (ty + 8i); dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        spt[(ty + 8 * i) * TS + tx + 16 * j] = st[i][j];
        sdst[(ty + 8 * i) * TS + tx + 16 * j] = dpt[i][j];
      }
    __syncwarp();
    mul_rows<BQ, SD, 2, 4, NG>(dvk, {spt, sdst}, {dos, qs}, ty, tx);
    it = nxt;
    queries = next_queries;
  }
  cp_async_wait<0>();  // no copy outlives the block, also where no item was live
  store_rows_f32<4, NG, VEC>(dk + base, dvk[1], k0, Sk, d, ty, tx);
  store_rows_f32<4, NG, VEC>(dv + base, dvk[0], k0, Sk, d, ty, tx);
}
