// The bfloat16 flash-attention backward on Hopper's tensor cores (sm_90a).
//
// Included by flash_attention.cu inside its anonymous namespace, after
// flash_fwd_tc.cuh, whose helpers it calls (smem_u32, cp_async_16 and its
// commit/wait, mma_bf16, ex2, kLog2e, load_rows_bf16; the fragment loads
// ldsm_a, ldsm_b and ldsm_bt; acc_to_a; store_acc_bf16), and after the mask
// policies (StaticMask, PosMask).  It has no includes of its own.
//
// flash_bwd_dq_bf16_kernel<D, VEC, Mask> is dq and flash_bwd_dkv_bf16_kernel
// <D, VEC, Mask> is dk and dv, for bfloat16 storage in all three of their
// uses.  They replace the Pallas TPU kernels
//   _flash_bwd_dq_kernel (heat_tpu/ops/flash_attention.py:339) and
//     _flash_bwd_dkv_kernel (l.376), via _flash_bwd_impl (l.517): flash_bwd_dq
//     and flash_bwd_dkv, under StaticMask;
//   _flash_gqa_bwd_impl (l.910): the same bodies with K/V row bh / group and
//     dk, dv summed over the group (l.924, 945): flash_gqa_bwd_dq and
//     flash_gqa_bwd_dkv, under StaticMask;
//   _flash_pos_bwd_dq_kernel (l.264) and _flash_pos_bwd_dkv_kernel (l.298),
//     via _flash_pos_bwd_impl (l.636): flash_pos_bwd_dq and
//     flash_pos_bwd_dkv, under PosMask.
// They compute what the float32 bodies (flash_bwd_dq_f32_kernel,
// flash_bwd_dkv_f32_kernel in flash_f32.cuh) compute, the reference's
// arithmetic: scores
// S = q.k in float32, P = exp(S * scale - lse) (0 where the mask drops the
// key), dP = dO.v in float32, dS = P * (dP - dd) * scale in float32 (dd =
// rowsum(dO * O), minus the lse cotangent for a ring block); then dq =
// bf16(dS).K, dv = bf16(P)^T.dO and dk = bf16(dS)^T.Q in float32, each
// rounded once to bfloat16.  Every product's operands are bfloat16 at the
// reference's rounding points (Q, K, V, dO stored so; P rounded to dO's
// type, dS to K's and Q's), so mma.sync's bf16 x bf16 -> float32 changes
// only the order of the sums, and how closely they round.  That matters
// where a sum is long: dk and dv sum over every query row of the group
// (g * Sq terms, 8192 at 8 query heads to a K/V head and S = 1024), so a
// rounding of P a few ulps off, or the tensor cores' own accumulation
// (which rounds less closely than a float32 add), reaches enough of the
// results to move their bf16 rounding.  So dk/dv takes P as expf(S * scale
// - lse), the plain version's arithmetic, and sums each 16 queries'
// products apart from 0 before adding them to its accumulators by float32
// adds (add_products).  dq sums over the keys only and keeps the
// forward's cheaper exp: 2^x on ex2.approx, log2 e folded into the scale
// and into lse.  With these, the share of bfloat16 results that differ
// from the plain version's at all stays within chip_smoke.py's 1% at
// every checked shape (PERF.md §6).  Nothing crosses blocks and there
// are no atomics, so runs repeat bit for bit.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), causal, at 6
// (dq) and 8 (dk/dv) FLOP a live (q, k) pair and d:
//   (B*H, S, d) = (64, 1024, 64), the LM training step's attention: dq 12.9
//     GFLOP (13.0 us) against 42.5 MB of q, k, v, dO, dq, lse and dd (12.7
//     us); dk/dv 17.2 GFLOP (17.4 us) against 50.9 MB (15.2 us): both
//     compute-bound, barely, at 0.0130 and 0.0174 ms;
//   (32, 4096, 64), the repository's attention benchmark: dq 103 GFLOP
//     (0.104 ms), dk/dv 137 GFLOP (0.139 ms): compute-bound.
// What the design does about it:
//   * every product runs on the tensor cores: mma.sync m16n8k16, bf16 x
//     bf16 -> float32.  A warp owns 16 rows of the product's M side (16
//     query rows for dq, 16 keys for dk/dv) and walks the other side in
//     steps (kDqChunk = 32 keys for dq, kDkvChunk = 16 queries for dk/dv),
//     so S and dP take few registers a step and the float32 accumulators
//     (dq; dk and dv) stay in registers for the whole loop.  dk/dv's step
//     is 16 queries because at 32 ptxas spilled at D = 64 within 3 blocks
//     an SM;
//   * dq: Q and dO fragments stay in registers; K and V are the B operands
//     of S = Q K^T and dP = dO V^T, read by ldmatrix from the row-major
//     [key][d] tiles, as the forward reads K; dS goes from the accumulators
//     straight into bf16 A fragments, as the forward's P does, and K is the
//     B operand of dQ += dS K by ldmatrix.trans, as the forward reads V.
//     K/V tiles of 64 keys sit in a ring of two shared-memory stages, the
//     next live tile filled by cp.async while the current one is used;
//   * dk/dv: one block per (K/V row, 64-key tile), whose K and V tiles stay
//     in shared memory; each warp reads its 16 keys' A fragments by
//     ldmatrix for each step (holding them, 2 * D / 4 registers, would not
//     fit beside the 2 * D / 2 of the dK and dV accumulators at D = 128).
//     Q and dO are the B operands of S^T = K Q^T and dP^T = V dO^T by
//     ldmatrix, and of dV += P^T dO and dK += dS^T Q by ldmatrix.trans,
//     each step's products summed apart and added in float32 (above).
//     For each query head of the group, and in it each live query tile,
//     head by head and tile by tile as the float32 body sums, the Q and dO
//     tiles and that tile's lse and dd come through a ring of two stages
//     (cp.async, 16 bytes a thread for the tiles, 4 for lse and dd);
//   * grouped dk/dv sums the group's heads into one float32 accumulator and
//     rounds once, as the reference's plain version does;
//   * masks, by warp: a warp skips a tile that the mask leaves it no live
//     pair in, and masks element by element only where the tile is cut (the
//     causal diagonal, the ragged end, a positions tile not all live), where
//     a dead element's P is set to 0 (never exp of -inf: a row with no live
//     key has lse = -1e30).  On a full tile every row has a live key, so a
//     finite lse, and P needs no test.  Rows past the query rows and keys
//     past the key rows take part in nothing; a positions block with no
//     live pair still writes dq = dk = dv = 0;
//   * blocks go out heaviest causal tile first over every row; a block is
//     kBwdWarps = 4 warps, 64 rows, at kBwdMinBlocks blocks an SM (3 at
//     D = 64, 2 at D = 128, as ptxas budgets registers).  Grouped dk/dv
//     has bhk * ceil(S / 64) blocks, each g times a multi-head block's
//     work: 256 at the grouped LM's (64 -> 16, 1024, 64), under the 396
//     that fit on 132 SMs at 3 an SM, so it leaves a third of them idle;
//   * any d in [1, 128]: tiles are zero-padded to D = 64 or 128 columns in
//     shared memory and rows past the end load as zeros.  VEC (d % 8 == 0
//     and 16-byte aligned operands) loads by 16-byte cp.async and writes
//     16-byte rows; otherwise the same kernel goes element by element
//     through the same shared tiles, so the results are the same bits;
//   * the outputs are staged through the warp's own rows of a shared tile
//     (Q for dq, K and V for dk and dv: no other warp reads them) and
//     written in 16-byte rows.
// This is the Ampere-style mma.sync body, on the forward's fragment code.
// wgmma with TMA loads is the step after it.

constexpr int kBwdWarps = 4;  // a block: 4 warps of 16 rows, one 64-row tile
static_assert(16 * kBwdWarps == BQ && BQ == BK, "the backward's tiles are the masks' BQ and BK");
// keys a dq warp takes a step, queries a dk/dv warp takes a step, and the
// blocks an SM that ptxas budgets registers for: 3 at D = 64 (<= 170
// registers), 2 at D = 128 (<= 255)
constexpr int kDqChunk = 32, kDkvChunk = 16;
template <int D>
constexpr int kBwdMinBlocks = D == 64 ? 3 : 2;
static_assert(BK % kDqChunk == 0 && BQ % kDkvChunk == 0 && kDqChunk % 16 == 0 && kDkvChunk % 16 == 0,
              "a step is whole k16 slices of a tile");

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// acc[n] += the products of the A fragments a[kk] (16 rows; columns c0 +
// 16 kk ..) with rows c0 + 16 kk .. of a row-major [k][n] shared tile, read
// transposed.  Each pair of n8 tiles is summed apart, from 0, over the kk
// and only then added to acc by a float32 add: a long sum of products is
// not left to the tensor cores' own accumulation, which rounds less
// closely than an add (see flash_bwd_dkv_bf16_kernel)
template <int SD, int NO, int NK>
__device__ __forceinline__ void add_products(float (&acc)[NO][4], const uint32_t (&a)[NK][4],
                                             const __nv_bfloat16* tile, int c0, int lane) {
#pragma unroll
  for (int n = 0; n < NO; n += 2) {
    float part[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t b[4];
      ldsm_bt<SD>(b, tile, c0 + kk * 16, n * 8, lane);
      mma_bf16(part[0], a[kk], b[0], b[1]);
      mma_bf16(part[1], a[kk], b[2], b[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[n][i] += part[0][i];
      acc[n + 1][i] += part[1][i];
    }
  }
}

template <int D>
constexpr size_t dq_bf16_smem() {  // sq, sdo [BQ][D + pad]; sk, sv [2][BK][D + pad]
  return sizeof(__nv_bfloat16) * (2 * BQ + 4 * BK) * (D + kTcPad);
}
template <int D>
constexpr size_t dkv_bf16_smem() {  // sk, sv [BK][D + pad]; sq, sdo [2][BQ][D + pad]; lse, dd [2][BQ] float32
  return sizeof(__nv_bfloat16) * (2 * BK + 4 * BQ) * (D + kTcPad) + sizeof(float) * 4 * BQ;
}

template <int D, bool VEC, typename Mask>
__global__ void __launch_bounds__(kBwdWarps * 32, kBwdMinBlocks<D>)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             __nv_bfloat16* __restrict__ dq, int rows, int d, int group, float scale,
                             const Mask mask) {
  constexpr int NT = kBwdWarps * 32, SD = D + kTcPad;
  constexpr int KD = D / 16;         // k16 steps of d
  constexpr int NC = kDqChunk / 8;  // n8 tiles of S and dP a step, 8 keys each
  constexpr int NO = D / 8;          // n8 tiles of dQ, 8 columns each
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sdo = sq + BQ * SD;
  __nv_bfloat16* sk = sdo + BQ * SD;     // [2][BK][SD]
  __nv_bfloat16* sv = sk + 2 * BK * SD;  // [2][BK][SD]

  const int Sq = mask.q_rows(), Sk = mask.k_rows();
  const int nq = (Sq + BQ - 1) / BQ;
  const int iq = nq - 1 - int(blockIdx.x) / rows;  // heaviest causal tiles first, over every row
  const int bh = int(blockIdx.x) % rows;            // the query row; its K/V row is bh / group
  const int q0 = iq * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // a fragment's row (and row + 8) and column pair
  const int wq0 = q0 + warp * 16;        // the warp's first query row
  const int64_t kv_base = int64_t(bh / group) * Sk * d;
  q += int64_t(bh) * Sq * d;
  dout += int64_t(bh) * Sq * d;
  k += kv_base;
  v += kv_base;

  const float scale2 = scale * kLog2e;  // P = 2^(S * scale2 - lse * log2 e)
  const int qmax = mask.query_bound(q0);
  const int nk = mask.key_end(iq);
  auto next_live = [&](int ik, int2& keys) {  // the same in every warp; keys: the tile's (min, max) position
    for (; ik < nk; ++ik) {
      keys = mask.fwd_tile_range(ik * BK);
      if (mask.fwd_block_live(keys, qmax)) break;
    }
    return ik;
  };
  auto load_kv = [&](int ik, int stage) {
    load_rows_bf16<BK, D, NT, VEC>(sk + stage * BK * SD, k, ik * BK, Sk, d);
    load_rows_bf16<BK, D, NT, VEC>(sv + stage * BK * SD, v, ik * BK, Sk, d);
  };

  load_rows_bf16<BQ, D, NT, VEC>(sq, q, q0, Sq, d);
  load_rows_bf16<BQ, D, NT, VEC>(sdo, dout, q0, Sq, d);
  cp_async_commit();
  int2 keys, next_keys;
  int ik = next_live(0, keys);
  if (ik < nk) load_kv(ik, 0);
  cp_async_commit();
  // this lane's rows g and g + 8: lse in log2 units and dd; rows past Sq
  // compute on zeros and are not written
  float lse2[2], ddr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    lse2[r] = row < Sq ? lse[int64_t(bh) * Sq + row] * kLog2e : 0.f;
    ddr[r] = row < Sq ? dd[int64_t(bh) * Sq + row] : 0.f;
  }
  cp_async_wait<1>();  // the Q and dO tiles
  __syncthreads();

  uint32_t qf[KD][4], dof[KD][4];  // A fragments of the warp's 16 rows, d in k16 steps
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    ldsm_a<SD>(qf[kd], sq, warp * 16, kd * 16, lane);
    ldsm_a<SD>(dof[kd], sdo, warp * 16, kd * 16, lane);
  }

  const int2 span = mask.fwd_warp_span(wq0);  // the warp's query positions (min, max)
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int stage = 0; ik < nk; stage ^= 1) {
    const int k0 = ik * BK;
    const int nxt = next_live(ik + 1, next_keys);
    if (nxt < nk) load_kv(nxt, stage ^ 1);  // its buffer was released by the last barrier
    cp_async_commit();
    cp_async_wait<1>();  // tile ik has landed
    __syncthreads();
    if (mask.fwd_warp_live(keys, span)) {  // uniform in the warp
      const __nv_bfloat16* ks = sk + stage * BK * SD;
      const __nv_bfloat16* vs = sv + stage * BK * SD;
      const bool full = k0 + BK <= Sk && mask.fwd_tile_full(keys, span);
#pragma unroll 1
      for (int c0 = 0; c0 < BK; c0 += kDqChunk) {
        float s[NC][4], dp[NC][4];
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)  // S = Q K^T and dP = dO V^T: 2 NC independent products a step of d
#pragma unroll
          for (int j = 0; j < NC; j += 2) {
            uint32_t b[4];
            ldsm_b<SD>(b, ks, c0 + j * 8, kd * 16, lane);
            mma_bf16(s[j], qf[kd], b[0], b[1]);
            mma_bf16(s[j + 1], qf[kd], b[2], b[3]);
            ldsm_b<SD>(b, vs, c0 + j * 8, kd * 16, lane);
            mma_bf16(dp[j], dof[kd], b[0], b[1]);
            mma_bf16(dp[j + 1], dof[kd], b[2], b[3]);
          }
        // _recompute_p and dS: element (row wq0 + g + 8r, key k0 + c0 + 8j +
        // 2t + e) is s[j][2r + e]; s becomes dS = P (dP - dd) scale
        if (full) {
#pragma unroll
          for (int j = 0; j < NC; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = ex2(fmaf(s[j][i], scale2, -lse2[i / 2]));
              s[j][i] = p * (dp[j][i] - ddr[i / 2]) * scale;
            }
        } else {
          const int qp[2] = {mask.q_pos(wq0 + g), mask.q_pos(wq0 + g + 8)};  // this lane's rows
#pragma unroll
          for (int j = 0; j < NC; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + c0 + j * 8 + 2 * t + e;
              const int kp = mask.k_pos(col);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                float& x = s[j][2 * r + e];
                const float p = mask.dead(qp[r], kp, col) ? 0.f : ex2(fmaf(x, scale2, -lse2[r]));
                x = p * (dp[j][2 * r + e] - ddr[r]) * scale;
              }
            }
        }
        // dQ += bf16(dS) K: dS of keys c0 + 16kk .. + 15 is the A fragment, K^T read transposed
#pragma unroll
        for (int kk = 0; kk < kDqChunk / 16; ++kk) {
          uint32_t a[4];
          acc_to_a(a, s, kk);
#pragma unroll
          for (int n = 0; n < NO; n += 2) {
            uint32_t b[4];
            ldsm_bt<SD>(b, ks, c0 + kk * 16, n * 8, lane);
            mma_bf16(acc[n], a, b[0], b[1]);
            mma_bf16(acc[n + 1], a, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    ik = nxt;
    keys = next_keys;
  }

  // dq through the warp's own rows of sq (no other warp reads them); offset
  // here, so no 64-bit offset stays live through the loop
  store_acc_bf16<D, VEC>(dq + int64_t(bh) * Sq * d, sq + warp * 16 * SD, acc, wq0, Sq, d, lane);
}

template <int D, bool VEC, typename Mask>
__global__ void __launch_bounds__(kBwdWarps * 32, kBwdMinBlocks<D>)
    flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dd,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int rows, int d,
                              int group, float scale, const Mask mask) {
  constexpr int NT = kBwdWarps * 32, SD = D + kTcPad;
  constexpr int KD = D / 16;         // k16 steps of d
  constexpr int NC = kDkvChunk / 8;  // n8 tiles of S^T and dP^T a step, 8 queries each
  constexpr int NO = D / 8;          // n8 tiles of dK and dV, 8 columns each
  static_assert(NT == 2 * BQ, "one thread a row of lse or of dd");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sv = sk + BK * SD;
  __nv_bfloat16* sq = sv + BK * SD;      // [2][BQ][SD]
  __nv_bfloat16* sdo = sq + 2 * BQ * SD;  // [2][BQ][SD]
  float* slse = reinterpret_cast<float*>(sdo + 2 * BQ * SD);  // [2][BQ]
  float* sdd = slse + 2 * BQ;                                 // [2][BQ]

  const int Sq = mask.q_rows(), Sk = mask.k_rows();
  const int ik = int(blockIdx.x) / rows;  // under causal the first key tiles have the most work: first
  const int bh = int(blockIdx.x) % rows;  // the K/V row; its query rows are bh * group + h
  const int k0 = ik * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wk0 = k0 + warp * 16;  // the warp's first key
  const int64_t base = int64_t(bh) * Sk * d;
  k += base;
  v += base;

  // the items: each query head of the group, and in it the query tiles from
  // query_begin on, head by head; the live ones are those whose queries see
  // some key of this block
  const int nq = (Sq + BQ - 1) / BQ;
  const int qbegin = mask.query_begin(ik);
  const int per_head = nq - qbegin, items = group * per_head;
  const int2 keys = mask.fwd_tile_range(k0);  // the block's key positions (min, max)
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
    load_rows_bf16<BQ, D, NT, VEC>(sq + stage * BQ * SD, q + qrow * Sq * d, q0, Sq, d);
    load_rows_bf16<BQ, D, NT, VEC>(sdo + stage * BQ * SD, dout + qrow * Sq * d, q0, Sq, d);
    const int i = threadIdx.x % BQ, row = q0 + i;  // threads [0, BQ) read lse, [BQ, 2 BQ) dd
    const float* src = (threadIdx.x < BQ ? lse : dd) + qrow * Sq;
    cp_async_4(smem_u32((threadIdx.x < BQ ? slse : sdd) + stage * BQ + i), row < Sq ? src + row : src, row < Sq);
  };

  load_rows_bf16<BK, D, NT, VEC>(sk, k, k0, Sk, d);
  load_rows_bf16<BK, D, NT, VEC>(sv, v, k0, Sk, d);
  int2 queries, next_queries;
  int it = next_live(0, queries);
  if (it < items) load_q(it, 0);
  cp_async_commit();

  const int2 span = mask.bwd_warp_span(wk0);  // the warp's key positions (min, max)
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  for (int stage = 0; it < items; stage ^= 1) {
    const int q0 = (qbegin + it % per_head) * BQ;
    const int nxt = next_live(it + 1, next_queries);
    if (nxt < items) load_q(nxt, stage ^ 1);  // its buffers were released by the last barrier
    cp_async_commit();
    cp_async_wait<1>();  // item it (and, the first time, the K/V tiles) has landed
    __syncthreads();
    if (wk0 < Sk && mask.bwd_warp_live(queries, span)) {  // uniform in the warp; keys past Sk are not written
      const __nv_bfloat16* qs = sq + stage * BQ * SD;
      const __nv_bfloat16* dos = sdo + stage * BQ * SD;
      const float* lse_s = slse + stage * BQ;
      const float* dd_s = sdd + stage * BQ;
      const bool full = q0 + BQ <= Sq && mask.bwd_tile_full(queries, span);
#pragma unroll 1
      for (int c0 = 0; c0 < BQ; c0 += kDkvChunk) {
        float st[NC][4], dpt[NC][4];
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {  // S^T = K Q^T and dP^T = V dO^T
          uint32_t a[4], b[4];
          ldsm_a<SD>(a, sk, warp * 16, kd * 16, lane);
#pragma unroll
          for (int j = 0; j < NC; j += 2) {
            ldsm_b<SD>(b, qs, c0 + j * 8, kd * 16, lane);
            mma_bf16(st[j], a, b[0], b[1]);
            mma_bf16(st[j + 1], a, b[2], b[3]);
          }
          ldsm_a<SD>(a, sv, warp * 16, kd * 16, lane);
#pragma unroll
          for (int j = 0; j < NC; j += 2) {
            ldsm_b<SD>(b, dos, c0 + j * 8, kd * 16, lane);
            mma_bf16(dpt[j], a, b[0], b[1]);
            mma_bf16(dpt[j + 1], a, b[2], b[3]);
          }
        }
        // P^T and dS^T: element (key wk0 + g + 8r, query q0 + c0 + 8j + 2t +
        // e) is st[j][2r + e]; st becomes P^T, dpt dS^T = P^T (dP^T - dd) scale
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float2 lc = *reinterpret_cast<const float2*>(lse_s + c0 + j * 8 + 2 * t);
          const float2 dc = *reinterpret_cast<const float2*>(dd_s + c0 + j * 8 + 2 * t);
          const float lsec[2] = {lc.x, lc.y}, ddc[2] = {dc.x, dc.y};
          if (full) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              st[j][i] = expf(fmaf(st[j][i], scale, -lsec[i % 2]));
              dpt[j][i] = st[j][i] * (dpt[j][i] - ddc[i % 2]) * scale;
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = q0 + c0 + j * 8 + 2 * t + e;  // query rows past Sq take part in nothing
              const int qp = mask.q_pos(row);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int key = wk0 + g + 8 * r;  // this lane's keys
                float& x = st[j][2 * r + e];
                x = row >= Sq || mask.dead(qp, mask.k_pos(key), key) ? 0.f : expf(fmaf(x, scale, -lsec[e]));
                dpt[j][2 * r + e] = x * (dpt[j][2 * r + e] - ddc[e]) * scale;
              }
            }
          }
        }
        // dV += bf16(P^T) dO, then dK += bf16(dS^T) Q, over this step's queries
        uint32_t a[kDkvChunk / 16][4];
#pragma unroll
        for (int kk = 0; kk < kDkvChunk / 16; ++kk) acc_to_a(a[kk], st, kk);
        add_products<SD>(dva, a, dos, c0, lane);
#pragma unroll
        for (int kk = 0; kk < kDkvChunk / 16; ++kk) acc_to_a(a[kk], dpt, kk);
        add_products<SD>(dka, a, qs, c0, lane);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    it = nxt;
    queries = next_queries;
  }

  // dk and dv through the warp's own rows of sk and sv (no other warp reads
  // them), once every thread's K/V copies have landed, also where no item
  // was live
  cp_async_wait<0>();
  __syncthreads();
  store_acc_bf16<D, VEC>(dk + base, sk + warp * 16 * SD, dka, wk0, Sk, d, lane);
  store_acc_bf16<D, VEC>(dv + base, sv + warp * 16 * SD, dva, wk0, Sk, d, lane);
}
