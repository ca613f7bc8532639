// The bfloat16 flash-attention forward on Hopper's tensor cores (sm_90a).
//
// Included by flash_attention.cu inside its anonymous namespace, after the
// mask policies (StaticMask, PosMask), whose members it calls, and after
// BQ, BK, kNoMass, kFwdWarps and kFwdMinBlocks.  It has no includes of its
// own.
//
// flash_fwd_bf16_kernel<D, VEC, Mask> is the forward for bfloat16 storage
// in all three of its uses.  It replaces the Pallas TPU kernels
//   _flash_kernel (heat_tpu/ops/flash_attention.py:132) via _flash_fwd_impl
//     (l.479), with _masked_scores (l.167), _online_update (l.94) and
//     _finalize (l.117): flash_fwd, under StaticMask;
//   _flash_gqa_fwd_impl (l.871): the same body with K/V row bh / group
//     (_gqa_kv_row, l.862): flash_gqa_fwd, under StaticMask;
//   _flash_pos_kernel (l.235) via _flash_pos_fwd_impl (l.596), with
//     _masked_scores_pos (l.206) and _block_live (l.225): flash_pos_fwd,
//     under PosMask.
// It computes what the float32 body (flash_fwd_f32_kernel) computes, the
// reference's arithmetic.  Scores are q.k in float32 times scale, -inf
// where the mask drops them: top-left causal, keys past the key rows, the
// positions mask.  After each 64-key tile it takes the running maximum m,
// P = exp(s - m) in float32 (0 where s = -inf; m stays -inf while a row
// has seen no live key), l = l * corr + rowsum(P) and O = O * corr +
// bf16(P) . V in float32; P is rounded to V's type, as the reference
// rounds it.  It ends with O / max(l, 1e-30) rounded to bfloat16 and
// lse = m + log(l), or -1e30 where l = 0, so rows with no live key give
// O = 0.  One difference: exp(s - m) is 2^(s' - m') with s' = q.k *
// (scale * log2 e), on ex2.approx.  That is within a few float32 ulps of
// expf, so a bf16 P rounds apart from the plain version's only rarely;
// the share of outputs that differ at all stays within chip_smoke.py's
// 1% (at most 0.44% on an NVIDIA H100 80GB HBM3 at 700 W).  Nothing
// crosses blocks and there are no atomics, so runs repeat bit for bit.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), causal:
//   (B*H, S, d) = (64, 1024, 64), the LM training step's attention: 8.6
//     GFLOP (8.7 us) against 33.8 MB of q, k, v, out and lse (10.1 us):
//     bytes-bound at 0.0101 ms, on a small grid with a tail;
//   (32, 4096, 64), the repository's attention benchmark: 68.7 GFLOP
//     (69.5 us) against 67.6 MB (20 us): compute-bound at 0.0695 ms.
// What the design does about it:
//   * both products run on the tensor cores: mma.sync m16n8k16, bf16 x
//     bf16 -> float32 (S = Q K^T, O += P V).  Each warp owns 16 query rows,
//     and its Q fragments stay in registers for the whole key loop.  K is
//     the B operand, read with ldmatrix from the row-major [key][d] tile;
//     V is read with ldmatrix.trans.  P goes from the S accumulators
//     straight into bf16 A fragments, never through memory.  The products
//     of one step of d are issued together, 8 independent accumulators;
//   * the row max and the row sum reduce over the 4 lanes that share a
//     fragment row (shfl_xor 1, 2); l stays a per-lane sum until the end;
//   * K/V tiles hold 64 keys, the key tile of the plain version's online
//     softmax, so bf16 P rounds at the same running maximum.  They sit in
//     a ring of two shared-memory stages.  The next live tile is filled by
//     cp.async (16 bytes a thread) while the current one is multiplied.
//     Rows are padded by 16 bytes, so ldmatrix's 8 rows fall in 8
//     distinct bank groups;
//   * a block is kFwdWarps = 4 warps, 64 query rows, at 3 blocks an SM for
//     D = 64 (ptxas: <= 170 registers, no spills) and 2 for D = 128.
//     Blocks go out heaviest causal tile first over every row, against the
//     grid's tail.  A warp skips a key tile wholly in the future of its
//     rows.  Only a tile that the mask cuts (the causal diagonal, the
//     ragged end, a positions tile not all live) is masked element by
//     element.  Under PosMask each warp reads a tile's positions once (min
//     and max), one tile ahead;
//   * any d in [1, 128]: tiles are zero-padded to D = 64 or 128 columns in
//     shared memory, and rows past the end load as zeros, so S is never
//     padded in device memory.  VEC (d % 8 == 0 and 16-byte aligned
//     operands) loads by 16-byte cp.async.  Otherwise the same kernel
//     loads element by element (d = 33, a tensor at an odd storage
//     offset), into the same shared tiles, so the results are the same
//     bits;
//   * the output is staged through the warp's rows of the Q tile and
//     written in 16-byte rows.
// This is the Ampere-style mma.sync body.  Hopper's wgmma with TMA loads,
// a producer warp and a deeper ring is the step after it.

constexpr int kTcPad = 8;  // padding of each shared row, in bfloat16: 16 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: a 16 x 16 bf16 (row-major fragment), b 16 x 8 bf16 (column-major), c float32.
// Not volatile: it touches no memory, so the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x; -inf gives 0, and results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// two floats rounded to bfloat16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + R) of a row-major (n, d) bf16 matrix into the shared tile
// dst[R][D + kTcPad]; rows >= n and columns >= d are zero.
template <int R, int D, int NT, bool VEC>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int r0,
                                               int n, int d) {
  constexpr int SD = D + kTcPad;
  if constexpr (VEC) {
    constexpr int C = D / 8, RS = NT / C;  // 16-byte chunks a row; rows a pass of the block
    static_assert(NT % C == 0 && R % RS == 0, "the passes must tile the rows");
    const int c = threadIdx.x % C, r1 = threadIdx.x / C;  // this thread's chunk, and its row in the first pass
    const __nv_bfloat16* from = src + int64_t(r0 + r1) * d + c * 8;
    const uint32_t to = smem_u32(dst + r1 * SD + c * 8);
#pragma unroll
    for (int i = 0; i < R / RS; ++i) {
      const bool valid = r0 + r1 + i * RS < n && c * 8 < d;
      cp_async_16(to + i * RS * SD * 2, valid ? from + int64_t(i * RS) * d : src, valid);
    }
  } else {
    for (int e = threadIdx.x; e < R * D; e += NT) {
      const int r = e / D, c = e % D;
      dst[r * SD + c] = r0 + r < n && c < d ? src[int64_t(r0 + r) * d + c] : __float2bfloat16(0.f);
    }
  }
}

// The A fragment (16 x 16) of rows [r0, r0 + 16) and columns [c0, c0 + 16)
// of a row-major shared tile with row stride SD
template <int SD>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0, int c0, int lane) {
  ldsm_x4(a, smem_u32(tile + (r0 + lane % 8 + (lane / 8 % 2) * 8) * SD + c0 + (lane / 16) * 8));
}
// The B fragments of two n8 tiles (b[0..1] columns n0.., b[2..3] n0 + 8..)
// with k in [k0, k0 + 16), from a row-major [n][k] shared tile
template <int SD>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0, int k0, int lane) {
  ldsm_x4(b, smem_u32(tile + (n0 + lane % 8 + (lane / 16) * 8) * SD + k0 + (lane / 8 % 2) * 8));
}
// The same from a row-major [k][n] shared tile, read transposed
template <int SD>
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0, int n0, int lane) {
  ldsm_x4_trans(b, smem_u32(tile + (k0 + lane % 8 + (lane / 8 % 2) * 8) * SD + n0 + (lane / 16) * 8));
}

// The A fragment of 16 rows and the 16 columns [16 kk, 16 kk + 16) of a
// float32 accumulator x[n8 tile][4], rounded to bfloat16
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[N][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// A warp's float32 accumulator of 16 rows x D columns, rounded to bfloat16,
// into its 16 staged rows so[16][D + kTcPad], then rows [r0, r0 + 16) of
// the row-major (n, d) dst below n: 16-byte rows with VEC, else element by
// element
template <int D, bool VEC>
__device__ __forceinline__ void store_acc_bf16(__nv_bfloat16* __restrict__ dst, __nv_bfloat16* so,
                                               const float (&acc)[D / 8][4], int r0, int n, int d, int lane) {
  constexpr int SD = D + kTcPad;
  const int g = lane / 4, t = lane % 4;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(so + (g + 8 * r) * SD + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
  __syncwarp();
  if constexpr (VEC) {
    constexpr int C = D / 8;
#pragma unroll
    for (int e = lane; e < 16 * C; e += 32) {
      const int r = e / C, c = e % C;
      if (r0 + r < n && c * 8 < d)
        *reinterpret_cast<uint4*>(dst + int64_t(r0 + r) * d + c * 8) =
            *reinterpret_cast<const uint4*>(so + r * SD + c * 8);
    }
  } else {
    for (int e = lane; e < 16 * D; e += 32) {
      const int r = e / D, c = e % D;
      if (r0 + r < n && c < d) dst[int64_t(r0 + r) * d + c] = so[r * SD + c];
    }
  }
}

template <int D>
constexpr size_t fwd_bf16_smem() {  // sq [BQ][D + pad]; sk, sv [2][BK][D + pad]
  return sizeof(__nv_bfloat16) * (BQ + 4 * BK) * (D + kTcPad);
}

template <int D, bool VEC, typename Mask>
__global__ void __launch_bounds__(kFwdWarps * 32, kFwdMinBlocks<D>)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int rows, int d, int group, float scale, const Mask mask) {
  constexpr int NT = kFwdWarps * 32, SD = D + kTcPad;  // a block: BQ query rows, 16 a warp
  constexpr int KD = D / 16;  // k16 steps of Q K^T
  constexpr int NS = BK / 8;  // n8 tiles of S, 8 keys each
  constexpr int NO = D / 8;   // n8 tiles of O, 8 columns each
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sk = sq + BQ * SD;      // [2][BK][SD]
  __nv_bfloat16* sv = sk + 2 * BK * SD;  // [2][BK][SD]

  const int Sq = mask.q_rows(), Sk = mask.k_rows();
  const int nq = (Sq + BQ - 1) / BQ;
  const int iq = nq - 1 - int(blockIdx.x) / rows;  // heaviest causal tiles first, over every row
  const int bh = int(blockIdx.x) % rows;            // the query row; its K/V row is bh / group
  const int q0 = iq * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // a fragment's row (and row + 8) and column pair
  const int wq0 = q0 + warp * 16;          // the warp's first query row
  const int64_t kv_base = int64_t(bh / group) * Sk * d;
  q += int64_t(bh) * Sq * d;
  k += kv_base;
  v += kv_base;

  const float scale2 = scale * kLog2e;  // scores in log2 units: exp(s - m) = 2^(s2 - m2)
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
  cp_async_commit();
  int2 keys, next_keys;
  int ik = next_live(0, keys);
  if (ik < nk) load_kv(ik, 0);
  cp_async_commit();
  cp_async_wait<1>();  // the Q tile
  __syncthreads();

  uint32_t qf[KD][4];  // A fragments of the warp's 16 rows, d in k16 steps
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) ldsm_a<SD>(qf[kd], sq, warp * 16, kd * 16, lane);

  const int2 span = mask.fwd_warp_span(wq0);  // the warp's query positions (min, max)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[NO][4];  // m in log2 units
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int stage = 0; ik < nk; stage ^= 1) {
    const int k0 = ik * BK;
    const int nxt = next_live(ik + 1, next_keys);
    if (nxt < nk) load_kv(nxt, stage ^ 1);  // its buffer was released by the last barrier
    cp_async_commit();
    cp_async_wait<1>();  // tile ik has landed
    __syncthreads();
    if (mask.fwd_warp_live(keys, span)) {  // uniform in the warp; rows past Sq compute on zeros, unwritten
      const __nv_bfloat16* ks = sk + stage * BK * SD;
      const __nv_bfloat16* vs = sv + stage * BK * SD;
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)  // S = Q K^T: 8 independent products a step of d
#pragma unroll
        for (int j = 0; j < NS; j += 2) {  // key tiles j and j + 1
          uint32_t b[4];
          ldsm_b<SD>(b, ks, j * 8, kd * 16, lane);
          mma_bf16(s[j], qf[kd], b[0], b[1]);
          mma_bf16(s[j + 1], qf[kd], b[2], b[3]);
        }
      // _masked_scores, in log2 units (scale * log2 e): element (row g + 8r,
      // key k0 + 8j + 2t + e) is s[j][2r + e]
      if (k0 + BK <= Sk && mask.fwd_tile_full(keys, span)) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] *= scale2;
      } else {
        const int qp[2] = {mask.q_pos(wq0 + g), mask.q_pos(wq0 + g + 8)};  // this lane's rows
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + j * 8 + 2 * t + e;
            const int kp = mask.k_pos(col);
#pragma unroll
            for (int r = 0; r < 2; ++r)
              s[j][2 * r + e] = mask.dead(qp[r], kp, col) ? -INFINITY : s[j][2 * r + e] * scale2;
          }
      }
      // _online_update: rows with no live key so far keep m = -inf
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float safe = isfinite(m_new) ? m_new : 0.f;
        corr[r] = ex2(m[r] - safe);  // 0 while m was -inf, 1 where it stays
        m[r] = m_new;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * r + e];
            x = ex2(x - safe);  // now p: 0 where the score is -inf
            ps += x;
          }
        l[r] = l[r] * corr[r] + ps;  // this lane's share of the row sum
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      // O += bf16(P) V: the S accumulators of keys 16kk .. 16kk + 15 are the A fragment
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s, kk);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          ldsm_bt<SD>(b, vs, kk * 16, n * 8, lane);
          mma_bf16(o[n], a, b[0], b[1]);
          mma_bf16(o[n + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    ik = nxt;
    keys = next_keys;
  }

  // _finalize, through the warp's own rows of sq (no other warp reads them);
  // the outputs are offset here, so no 64-bit offset stays live through the loop
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] /= den[i / 2];
  store_acc_bf16<D, VEC>(out + int64_t(bh) * Sq * d, sq + warp * 16 * SD, o, wq0, Sq, d, lane);
  lse += int64_t(bh) * Sq;
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq0 + g + 8 * r;
      if (row < Sq) lse[row] = l[r] > 0.f ? (isfinite(m[r]) ? m[r] : 0.f) * kLn2 + logf(den[r]) : kNoMass;
    }
  }
}
