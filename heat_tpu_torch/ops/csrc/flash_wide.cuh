// The wide route's forward: flash attention at head dims past 256, included
// once by flash_attention_wide.cu inside flash_launch.cuh's anonymous
// namespace, after flash_wide_bwd.cuh, whose clusters, operand tiles, ring
// and schedule (wb_schedule) it runs on.
//
// Replaces, past d = 256, the Pallas TPU kernels of
// heat_tpu/ops/flash_attention.py:
//   flash_wide_fwd_kernel <- _flash_kernel (l.132, through _flash_fwd_impl
//                            l.479, call l.488), grouped through
//                            _flash_gqa_fwd_impl (l.871, call l.881), and
//                            _flash_pos_kernel (l.235, call l.605)
// It computes what the forward bodies of flash_f32.cuh and flash_fwd_tc.cuh
// compute (O and lse, under StaticMask and PosMask, with GQA's K/V row b / g
// for query row b), at any d > 256.
//
// Bound at (B*H, S, d) = (64, 1024, 512) causal on an H100 SXM: 2 products
// of 2*BH*S^2*d/2 FLOP (68.7 GFLOP: 1.026 ms at 67 TFLOP/s float32, 0.069 ms
// at 989 TFLOP/s bf16), against 537 MB of float32 inputs and outputs read
// and written once (0.160 ms at 3.35 TB/s): compute-bound in float32,
// bytes-bound in bfloat16 (269 MB: 0.080 ms, above the products' 0.069).
//
// A 64-row tile of O at d = 512 is 128 KB of float32 accumulators, past one
// SM's registers, so a tile's output columns are split over the blocks of
// a thread block cluster, as the backward's (flash_wide_bwd.cuh's note):
//
// - Blocks and cluster.  Block rank r of a cluster of n_c owns a chunk of C
//   output columns (C = 128 in bfloat16, 64 in float32) of one 64-row query
//   tile and keeps its Q chunk in shared memory for the whole key loop.
//   Where d needs more than 8 chunks, n_p passes (clusters) share a tile,
//   each forming S over all of d (WbSteps), as the backward's do.
// - Each live key tile is formed once a pass.  Each block forms the partial
//   S = Q_c K_c^T over its own columns (the two warpgroups each over half
//   of them, into two float32 tiles).  After a cluster barrier the block
//   owning rows [r * 64 / n_c, (r + 1) * 64 / n_c) sums every block's
//   partials for those rows in rank order through distributed shared
//   memory, masks and scales them, and updates the rows' running max m and
//   sum l: m_new = max(m_old, the tile's max), corr = exp(m_old - m_new),
//   P = exp(S - m_new), l = l corr + sum(P).  It rounds P to V's type (the
//   plain version's rounding point) and pushes P, corr and l into every
//   block's shared memory.  After a second barrier each block computes
//   O_c = diag(corr) O_c + P V_c.  One block decides each row's m, so the
//   cluster agrees on it; the products a live pair executes are the
//   bound's 2 (QK^T at full d once, P.V once), n_p + 1 where d takes passes.
//   At the end O_c / l is written, and the owner of a row writes its lse
//   (kNoMass where no key is live).
// - Products.  Bfloat16 on wgmma from TMA-loaded tiles in the core-matrix
//   layout: m64n64k16 for the partial scores (each warpgroup 4 of the 8
//   k-steps of its chunk), m64n64 for P V_c (each warpgroup 64 of the 128
//   columns, V_c read MN-major through the descriptor's transpose bit).
//   Float32 on the CUDA cores in full IEEE float32 (no TF32), 8 x 4
//   register patches read as float4 from padded cp.async tiles; P V_c is
//   split over the two warpgroups by keys and added at the end.
// - Loads.  K_c and V_c of a key tile come through the two-stage mbarrier
//   ring, one tile ahead; the barriers are split into arrive and wait, so
//   the next tile's partial S runs while this tile's pushes land
//   (wb_schedule).  Only the partial S (float32) and P, corr and l cross
//   distributed shared memory.
//
// The live-tile test depends only on the query and key tiles, the same in
// every block of a cluster, so all take the same branches at its barriers;
// a tile with no live key tile writes O = 0.  No atomics and fixed sum
// orders: runs repeat bit for bit.

// The shared memory of a forward block, in bytes from its start rounded up
// to 1 KB: the own tile Q_c, the ring (2 stages of K_c and V_c), the
// partial scores of each stage (one float32 64 x 64 tile a warpgroup), the
// pushed P, the rows (the running max m and sum l of the rows the block
// owns, l of every row as pushed, corr of every row as pushed) and the
// ring's two mbarriers; BYTES counts the rounding.
template <typename T>
struct WfSmem {
  static constexpr bool F32 = std::is_same_v<T, float>;
  static constexpr int C = kWbC<T, false>, TILE = WbTile<T, C>::BYTES;
  static constexpr int RED = 64 * kWbRld * 4, PUSHED = WbPushed<T>::BYTES;
  static constexpr int STAGE = TILE, RED_OFF = STAGE + 4 * TILE, PUSHED_OFF = RED_OFF + 4 * RED,
                       ROWS_OFF = PUSHED_OFF + PUSHED, BAR_OFF = ROWS_OFF + 3 * 64 * 4, BYTES = BAR_OFF + 2 * 8 + 1024;
};
constexpr int kWfM = 0, kWfL = 64, kWfCorr = 128;  // the rows: offsets in floats

// The forward's partial scores of one chunk: warpgroup h sums Q_c K_c^T over
// the chunk's columns [C h / 2, C (h + 1) / 2) into red_h, stored for a key
// tile's first chunk and added after it (passes).
__device__ __forceinline__ void wf_partial(const WbAcc<float, false>& acc, const float* x, const float* y,
                                           float* red0, float* red1, bool first) {
  constexpr int C = WbAcc<float, false>::C, K = C / 2;
  float ps[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ps[i][j] = 0.f;
  f32_nt<C, K>(ps, x + K * acc.h, y + K * acc.h, acc.rg, acc.cg);
  float* red = acc.h ? red1 : red0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float& r = red[(acc.rg + 8 * i) * kWbRld + acc.cg + 16 * j];
      r = first ? ps[i][j] : r + ps[i][j];
    }
}
__device__ __forceinline__ void wf_partial(const WbAcc<__nv_bfloat16, false>& acc, const __nv_bfloat16* x,
                                           const __nv_bfloat16* y, float* red0, float* red1, bool first) {
  constexpr int KS = WbAcc<__nv_bfloat16, false>::C / 32;  // k-steps a warpgroup: half of the chunk's
  float s[32];
  wb_wgmma_fence();
#pragma unroll
  for (int i = 0; i < KS; ++i) {  // K-major A and B: column octets 1 KB apart, k-steps 2 KB
    const int ks = KS * acc.h + i;
    wb_mma64<0>(s, wb_desc(x + 1024 * ks, 1024, 128), wb_desc(y + 1024 * ks, 1024, 128), i > 0);
  }
  wb_wgmma_commit_wait();
  wb_hold(s);
  float* red = acc.h ? red1 : red0;
#pragma unroll
  for (int r = 0; r < 32; r += 2) {
    float2& a = *reinterpret_cast<float2*>(red + wb_row(r) * kWbRld + wb_col(r));
    a = first ? make_float2(s[r], s[r + 1]) : make_float2(a.x + s[r], a.y + s[r + 1]);
  }
}

// Each row of the chunk's accumulator times f[row] (corr), or with DIV over
// max(f[row], 1e-30) (the final l)
template <bool DIV>
__device__ __forceinline__ float wf_row_op(float o, float f) {
  return DIV ? o / fmaxf(f, 1e-30f) : o * f;
}
template <bool DIV>
__device__ __forceinline__ void wf_rows(WbAcc<float, false>& acc, const float* f) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x = f[acc.rg + 8 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.o[i][j] = wf_row_op<DIV>(acc.o[i][j], x);
  }
}
template <bool DIV>
__device__ __forceinline__ void wf_rows(WbAcc<__nv_bfloat16, false>& acc, const float* f) {
#pragma unroll
  for (int r = 0; r < 32; ++r) acc.o[r] = wf_row_op<DIV>(acc.o[r], f[wb_row(r)]);
}

// The cluster's exchange for one key tile, between the two cluster
// barriers: this block's rows [rank * 64 / nc, (rank + 1) * 64 / nc) of S,
// summed over every rank's two partials in rank order, masked and scaled,
// update the rows' m and l (this block's rows of ``rows``), and P = exp(S -
// m_new) rounded to T, corr and l go into every block's pushed tile and
// rows.  Sixteen threads a row, four keys each.  Bfloat16 P is read by
// wgmma, through the async proxy: the stores are fenced for it here, and
// the reader fences again after the barrier (wb_pushed_ready).
template <typename T, typename Mask>
__device__ __forceinline__ void wf_exchange(const float* red0, const float* red1, T* pushed, float* rows, int nc,
                                            int rank, const Mask& mask, float scale, int q0, int k0) {
  using L = WbPushed<T>;
  const int lo = rank * 64 / nc, n4 = ((rank + 1) * 64 / nc - lo) * 16;
  const unsigned group = 0xffffu << (threadIdx.x & 16);  // the lanes of this thread's row
  for (int f = int(threadIdx.x); f < n4; f += kWbThreads) {
    const int r = lo + f / 16, c = (f % 16) * 4, at = r * kWbRld + c;
    const float m_old = rows[kWfM + r], l_old = rows[kWfL + r];
    float4 a[kWbMaxCluster], e[kWbMaxCluster];  // every rank's loads in flight at once
#pragma unroll
    for (int j = 0; j < kWbMaxCluster; ++j)
      if (j < nc) {
        a[j] = *reinterpret_cast<const float4*>(wb_map(red0, j) + at);
        e[j] = *reinterpret_cast<const float4*>(wb_map(red1, j) + at);
      }
    float4 s = make_float4(a[0].x + e[0].x, a[0].y + e[0].y, a[0].z + e[0].z, a[0].w + e[0].w);
#pragma unroll
    for (int j = 1; j < kWbMaxCluster; ++j)
      if (j < nc) {
        s = make_float4(s.x + a[j].x, s.y + a[j].y, s.z + a[j].z, s.w + a[j].w);
        s = make_float4(s.x + e[j].x, s.y + e[j].y, s.z + e[j].z, s.w + e[j].w);
      }
    const float sv[4] = {s.x, s.y, s.z, s.w};
    const int qp = mask.q_pos(q0 + r);
    float x[4], mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = k0 + c + u;
      x[u] = mask.dead(qp, mask.k_pos(col), col) ? -INFINITY : sv[u] * scale;
      mx = fmaxf(mx, x[u]);
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(group, mx, o));
    const float m_new = fmaxf(m_old, mx);
    float p[4], sum = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      p[u] = x[u] == -INFINITY ? 0.f : expf(x[u] - m_new);
      sum += p[u];
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(group, sum, o);
    const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new), l_new = l_old * corr + sum;
    for (int j = 0; j < nc; ++j) wb_store4(wb_map(pushed, j) + L::at(r, c), p);
    if (c == 0) {
      rows[kWfM + r] = m_new;
      for (int j = 0; j < nc; ++j) {
        wb_map(rows, j)[kWfL + r] = l_new;
        wb_map(rows, j)[kWfCorr + r] = corr;
      }
    }
  }
  if constexpr (!std::is_same_v<T, float>) asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The forward's view of the schedule (wb_schedule): block (b, query tile,
// pass p, rank r) of a cluster of nc blocks writes O[b, tile, chunk r + nc
// p] over the live key tiles (the partners), as dq's view (WbDq) does with
// Q alone as its own tile and P in place of dS.
template <typename T_, bool VEC, typename Mask>
struct WbFwd {
  static constexpr int KIND = 2;
  using T = T_;
  using B = WbBlock<T, false, WfSmem<T>>;
  static constexpr int C = B::C, TE = B::TE;
  static constexpr bool ASYNC = VEC || B::M::F32, TMA = VEC && !B::M::F32;
  B blk;
  WbAcc<T, false> acc;
  const T *qb, *kb, *vb;
  const CUtensorMap *mq, *mk, *mv;  // VEC: TMA views of q, k, v
  const Mask& mask;
  float scale;
  int b, bkv;  // the query row and its K/V row
  int Sq, Sk, d, q0, qmax, end;
  // key tiles [it, end) that the query tile sees: the next live one
  __device__ __forceinline__ int next_live(int it) const {
    while (it < end && !mask.fwd_block_live(mask.fwd_tile_range(it * BK), qmax)) ++it;
    return it;
  }
  __device__ __forceinline__ void load_own_async(int s) {
    wb_load<T, C, VEC>(blk.res, qb, q0, Sq, blk.steps.chunk(s) * C, d);
  }
  __device__ __forceinline__ void load_partner_async(int it, int s, int st) {
    const int c0 = blk.steps.chunk(s) * C;
    wb_load<T, C, VEC>(blk.stage(st), kb, it * BK, Sk, c0, d);
    wb_load<T, C, VEC>(blk.stage(st) + TE, vb, it * BK, Sk, c0, d);
  }
  // key tile it's first item into stage st (with Q_c), on the stage's
  // barrier: bfloat16 rows of whole 16-byte chunks by TMA from one thread,
  // the rest by every thread
  __device__ __forceinline__ void issue(int it, int st, bool own_too) {
    const int s = blk.steps.next(0);
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        const int c0 = blk.steps.chunk(s) * C;
        uint64_t* bar = blk.bar + st;
        wb_bar_expect(bar, (own_too ? 3 : 2) * B::M::TILE);
        if (own_too) wb_tma_tile<C>(blk.res, mq, c0, q0, b, bar);
        wb_tma_tile<C>(blk.stage(st), mk, c0, it * BK, bkv, bar);
        wb_tma_tile<C>(blk.stage(st) + TE, mv, c0, it * BK, bkv, bar);
      }
    } else {
      if (own_too) load_own_async(s);
      load_partner_async(it, s, st);
      wb_bar_arrive<ASYNC>(blk.bar + st);
    }
  }
  __device__ __forceinline__ void sync_loads() {  // and order them before the next TMA writes
    wb_cp_async_wait_all();
    wb_fence_async();
    __syncthreads();
  }
  __device__ __forceinline__ void load_own(int s) {
    __syncthreads();  // the last partial's reads of Q_c are done
    load_own_async(s);
    sync_loads();
  }
  __device__ __forceinline__ void load_partner_now(int it, int s, int st) {
    __syncthreads();
    load_partner_async(it, s, st);
    sync_loads();
  }
  __device__ __forceinline__ void rows(int, int) {}
  __device__ __forceinline__ void partial(int st, bool first) {
    wf_partial(acc, blk.res, blk.stage(st), blk.red_s(st), blk.red_dp(st), first);
  }
  __device__ __forceinline__ void exchange(int it, int st) {
    wf_exchange<T>(blk.red_s(st), blk.red_dp(st), blk.pushed, blk.rows, blk.steps.pl.nc, blk.steps.rank, mask,
                   scale, q0, it * BK);
  }
  // O_c = diag(corr) O_c + P V_c
  __device__ __forceinline__ void output(int st) {
    wf_rows<false>(acc, blk.rows + kWfCorr);
    acc.output(blk.pushed, blk.stage(st) + TE, nullptr, nullptr);
  }
};

template <typename T, bool VEC, typename Mask>
__global__ void __launch_bounds__(kWbThreads, 1)
    flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          T* __restrict__ out, float* __restrict__ lse, int d, int g, float scale, Mask mask,
                          const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv) {
  extern __shared__ float4 smem4[];
  const int Sq = mask.q_rows(), Sk = mask.k_rows();
  const WidePlan pl = wide_plan(d, kWbC<T, false>);
  const int nq = (Sq + BQ - 1) / BQ, rank = int(blockIdx.x % pl.nc);
  const int64_t cl = blockIdx.x / pl.nc;
  const int pass = int(cl % pl.np), iq = int((cl / pl.np) % nq);
  const int64_t b = (cl / pl.np) / nq;
  const int q0 = iq * BQ;
  WbFwd<T, VEC, Mask> kern{WbBlock<T, false, WfSmem<T>>(wb_smem_base(smem4), pl, rank, pass),
                           WbAcc<T, false>(),
                           q + b * Sq * d,
                           k + (b / g) * Sk * d,
                           v + (b / g) * Sk * d,
                           &mq,
                           &mk,
                           &mv,
                           mask,
                           scale,
                           int(b),
                           int(b / g),
                           Sq,
                           Sk,
                           d,
                           q0,
                           mask.query_bound(q0),
                           mask.key_end(iq)};
  float* rows = kern.blk.rows;
  if (threadIdx.x == 0) {  // TMA: one arrival and the bytes; else every thread's
    wb_bar_init(kern.blk.bar, kern.TMA ? 1 : kWbThreads);
    wb_bar_init(kern.blk.bar + 1, kern.TMA ? 1 : kWbThreads);
  }
  if (threadIdx.x < BQ) {
    rows[kWfM + threadIdx.x] = -INFINITY;
    rows[kWfL + threadIdx.x] = 0.f;
    rows[kWfCorr + threadIdx.x] = 0.f;
  }
  __syncthreads();
  wb_schedule(kern);
  kern.acc.finish(kern.blk.red);
  if (kern.blk.steps.owns()) {
    wf_rows<true>(kern.acc, rows + kWfL);
    T* ob = out + b * Sq * d;
    kern.acc.template store<VEC>(WbOut<T>{ob, ob, q0, Sq, (rank + pl.nc * pass) * kern.C, d});
  }
  if (pass == 0) {  // the rows this block owns: their lse
    const int lo = rank * 64 / pl.nc, hi = (rank + 1) * 64 / pl.nc, r = lo + int(threadIdx.x);
    if (r < hi && q0 + r < Sq) {
      const float l = rows[kWfL + r];
      lse[b * Sq + q0 + r] = l > 0.f ? rows[kWfM + r] + logf(l) : kNoMass;
    }
  }
}

template <typename T, typename Mask>
int wide_fwd_launch(const void* q, const void* k, const void* v, void* out, float* lse, int64_t bhq, int64_t bhk,
                    int d, float scale, Mask mask, cudaStream_t stream) {
  const bool vec = vec_ok<16 / int(sizeof(T))>(d, q, k, v, out);
  CUtensorMap m[4];
  const int err = wb_views<T>(m, vec, q, k, v, nullptr, bhq, bhk, mask.q_rows(), mask.k_rows(), d);
  if (err) return err;
  const auto kern = vec ? flash_wide_fwd_kernel<T, true, Mask> : flash_wide_fwd_kernel<T, false, Mask>;
  return launch_cluster(kern, WfSmem<T>::BYTES, kWbThreads, wide_bwd_blocks<T, false>(bhq, mask.q_rows(), d),
                        wide_plan(d, kWbC<T, false>).nc, bhq, bhk, mask, stream, static_cast<const T*>(q),
                        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), lse, d,
                        group_of(bhq, bhk), scale, mask, m[0], m[1], m[2]);
}
