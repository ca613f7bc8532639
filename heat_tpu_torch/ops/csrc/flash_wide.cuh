// The wide route's forward: flash attention at head dims past 256,
// included once by flash_attention_wide.cu inside flash_launch.cuh's
// anonymous namespace (the backward, dq and dk/dv, is flash_wide_bwd.cuh).
//
// It computes what the forward bodies of flash_f32.cuh and flash_fwd_tc.cuh
// compute (O and lse, under StaticMask and PosMask, with GQA's K/V row map),
// at any d > 256.  Those bodies keep a 64-row tile of Q and of O at full d
// in shared memory or registers; at d = 512 one float32 tile is 128 KB, so
// Q, K, V and the accumulator cannot all fit 227 KB of shared memory and
// 255 registers a thread.  Here the products are tiled along d:
//
// - A block owns one 64-row query tile and one chunk of 128 output columns
//   of O.  Only that chunk lives in registers.
// - Each 64 x 64 score tile S = Q K^T is rebuilt at full d by streaming Q
//   and K through shared memory in 64-column steps, then masked, and P is
//   written to shared memory rounded to V's type, the plain version's
//   rounding point.
// - The block keeps the running max and sum of its 64 rows in shared
//   memory (two threads a row); every chunk's block computes them alike,
//   and chunk 0's writes lse.
//
// So each chunk recomputes the score tiles: at d = 512 the forward does
// 4 x QK^T + P.V, 2.5 times the forward's operations.
//
// Products: float32 operands on the CUDA cores in full float32, a thread an
// 8 x (N / 16) patch of the 64 x N tile; bfloat16 operands on the tensor
// cores by mma.sync m16n8k16 with float32 accumulation, a warp 16 rows.
// Operands are read from shared memory element by element through
// accessors (row-major or transposed), which keeps one product routine for
// every operand layout; all sums are float32.  Tiles are loaded by plain
// element copies with zero fill past the rows and past d.  Every block
// writes disjoint outputs with no atomics, so results repeat bit for bit.
//
// Bound at (B*H, S, d) = (64, 1024, 512) causal: 4 * BH * S^2 * d / 2 =
// 68.7 GFLOP (1.03 ms at 67 TFLOP/s float32, 0.07 ms at 989 TFLOP/s bf16),
// against 537 MB of float32 inputs and outputs (0.16 ms at 3.35 TB/s):
// compute-bound in float32, bytes-bound in bfloat16 (268 MB, 0.08 ms).
// The recomputation above and the element-wise operand reads keep the route
// well off that bound.

constexpr int kWideThreads = 128;  // a block: 4 warps
constexpr int kWideDc = 64;        // columns of d each step of a score product streams
constexpr int kWideOc = 128;       // output columns of a forward block

// the stride of a shared tile of C columns: one padding word a row, so rows fall on other banks
template <typename T, int C>
constexpr int kWideLd = C + (sizeof(T) == 4 ? 1 : 2);

template <typename T>
__device__ __forceinline__ T wide_cast(float x);
template <>
__device__ __forceinline__ float wide_cast<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 wide_cast<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a shared tile read as a(r, c) = p[r][c], or transposed, a(r, c) = p[c][r]
template <typename T, int LD>
struct RowMajor {
  const T* p;
  __device__ __forceinline__ T operator()(int r, int c) const { return p[r * LD + c]; }
};
template <typename T, int LD>
struct ColMajor {
  const T* p;
  __device__ __forceinline__ T operator()(int r, int c) const { return p[c * LD + r]; }
};

// A 64 x N float32 accumulator spread over the block's 128 threads, N / 2
// elements a thread; element e sits at (row(e), col(e)) of the tile.
template <typename T, int N>
struct WideAcc;

// float32: thread t holds rows t / 16 + 8 i (i < 8), columns t % 16 + 16 j (j < N / 16)
template <int N>
struct WideAcc<float, N> {
  static constexpr int NJ = N / 16, E = 8 * NJ;
  float v[E];
  __device__ __forceinline__ float& at(int e) { return v[e]; }
  __device__ __forceinline__ static int row(int e) { return int(threadIdx.x) / 16 + 8 * (e / NJ); }
  __device__ __forceinline__ static int col(int e) { return int(threadIdx.x) % 16 + 16 * (e % NJ); }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = 0.f;
  }
  // += a b over kdim: a(m, kk) for m < 64, b(kk, n) for n < N
  template <typename A, typename B>
  __device__ __forceinline__ void add(const A& a, const B& b, int kdim) {
    const int tr = int(threadIdx.x) / 16, tc = int(threadIdx.x) % 16;
    for (int kk = 0; kk < kdim; ++kk) {
      float av[8], bv[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = a(tr + 8 * i, kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) bv[j] = b(kk, tc + 16 * j);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) v[i * NJ + j] = fmaf(av[i], bv[j], v[i * NJ + j]);
    }
  }
};

// two bfloat16 values as one mma.sync operand register, lo in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// bfloat16: warp w holds rows [16 w, 16 w + 16); element 4 t + x is the x-th
// accumulator of the lane's mma.sync fragment of the 16 x 8 tile t
template <int N>
struct WideAcc<__nv_bfloat16, N> {
  static constexpr int NT = N / 8, E = 4 * NT;
  float v[NT][4];
  __device__ __forceinline__ float& at(int e) { return v[e / 4][e % 4]; }
  __device__ __forceinline__ static int row(int e) {
    return 16 * (int(threadIdx.x) / 32) + int(threadIdx.x % 32) / 4 + 8 * ((e % 4) / 2);
  }
  __device__ __forceinline__ static int col(int e) { return 8 * (e / 4) + 2 * int(threadIdx.x % 4) + (e % 2); }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < E; ++e) at(e) = 0.f;
  }
  template <typename A, typename B>
  __device__ __forceinline__ void add(const A& a, const B& b, int kdim) {
    const int lane = int(threadIdx.x % 32), r = 16 * (int(threadIdx.x) / 32) + lane / 4, q2 = 2 * (lane % 4);
    for (int k0 = 0; k0 < kdim; k0 += 16) {
      const int c = k0 + q2;
      const uint32_t af[4] = {pack2(a(r, c), a(r, c + 1)), pack2(a(r + 8, c), a(r + 8, c + 1)),
                              pack2(a(r, c + 8), a(r, c + 9)), pack2(a(r + 8, c + 8), a(r + 8, c + 9))};
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n = 8 * t + lane / 4;
        mma_bf16(v[t], af, pack2(b(c, n), b(c + 1, n)), pack2(b(c + 8, n), b(c + 9, n)));
      }
    }
  }
};

// Rows [r0, r0 + R) and columns [c0, c0 + C) of a row-major (rows, d) matrix
// into the shared tile dst[R][LD]; entries past the rows or past d are zero.
template <typename T, int R, int C, int LD>
__device__ __forceinline__ void wide_load(T* dst, const T* __restrict__ src, int r0, int rows, int c0, int d) {
  for (int i = int(threadIdx.x); i < R * C; i += kWideThreads) {
    const int r = i / C, c = i % C, gr = r0 + r, gc = c0 + c;
    dst[r * LD + c] = gr < rows && gc < d ? src[int64_t(gr) * d + gc] : wide_cast<T>(0.f);
  }
}

// S = Q K^T of query rows [q0, q0 + 64) of qb against key rows [k0, k0 +
// 64) of kb, at full d: the operands stream through the shared tiles sq, sk
// 64 columns a step.  Starts and ends on a barrier-free point: the caller's
// tiles are free to be overwritten after it returns.
template <typename T>
__device__ __forceinline__ void wide_scores(WideAcc<T, BK>& s, T* sq, T* sk, const T* qb, const T* kb, int q0, int Sq,
                                            int k0, int Sk, int d) {
  constexpr int LD = kWideLd<T, kWideDc>;
  s.zero();
  for (int e0 = 0; e0 < d; e0 += kWideDc) {
    __syncthreads();  // the last step's reads are done
    wide_load<T, BQ, kWideDc, LD>(sq, qb, q0, Sq, e0, d);
    wide_load<T, BK, kWideDc, LD>(sk, kb, k0, Sk, e0, d);
    __syncthreads();
    s.add(RowMajor<T, LD>{sq}, ColMajor<T, LD>{sk}, kWideDc);
  }
}

// ss [BQ][BK + 1], m, l, corr [BQ] float; sq, sk [64][LDC], sv [BK][LDO], sp [BQ][LDP]
template <typename T>
constexpr size_t wide_fwd_smem() {
  return sizeof(float) * (BQ * (BK + 1) + 3 * BQ) +
         sizeof(T) * (2 * 64 * kWideLd<T, kWideDc> + BK * kWideLd<T, kWideOc> + BQ * kWideLd<T, BK>);
}

// The forward: block (b, query tile, chunk c) writes O[b, tile, chunk c]
// and, for c = 0, lse[b, tile].  P of key tile t is taken against the
// running max after t, rounded to V's type, and the chunk's accumulator is
// rescaled by exp(m_old - m_new) before P.V, as flash_f32.cuh does.
template <typename T, typename Mask>
__global__ void __launch_bounds__(kWideThreads)
    flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          T* __restrict__ out, float* __restrict__ lse, int d, int g, float scale, Mask mask) {
  constexpr int LDC = kWideLd<T, kWideDc>, LDO = kWideLd<T, kWideOc>, LDP = kWideLd<T, BK>, SS = BK + 1;
  extern __shared__ float4 smem4[];
  float* ss = reinterpret_cast<float*>(smem4);
  float* sm = ss + BQ * SS;
  float* sl = sm + BQ;
  float* sc = sl + BQ;
  T* sq = reinterpret_cast<T*>(sc + BQ);
  T* sk = sq + BQ * LDC;
  T* sv = sk + BK * LDC;
  T* sp = sv + BK * LDO;

  const int Sq = mask.q_rows(), Sk = mask.k_rows(), tid = int(threadIdx.x);
  const int nq = (Sq + BQ - 1) / BQ, nc = (d + kWideOc - 1) / kWideOc;
  const int c = int(blockIdx.x % nc);
  const int iq = int((blockIdx.x / nc) % nq);
  const int64_t b = int64_t(blockIdx.x / nc) / nq;
  const int q0 = iq * BQ, c0 = c * kWideOc;
  const T* qb = q + b * Sq * d;
  const T* kb = k + (b / g) * Sk * d;
  const T* vb = v + (b / g) * Sk * d;

  if (tid < BQ) {
    sm[tid] = -INFINITY;
    sl[tid] = 0.f;
  }
  WideAcc<T, kWideOc> o;
  o.zero();
  WideAcc<T, BK> s;
  const int qmax = mask.query_bound(q0), kend = mask.key_end(iq);
  for (int it = 0; it < kend; ++it) {
    const int k0 = it * BK;
    if (!mask.fwd_block_live(mask.fwd_tile_range(k0), qmax)) continue;  // the same in every warp
    wide_scores<T>(s, sq, sk, qb, kb, q0, Sq, k0, Sk, d);
#pragma unroll
    for (int e = 0; e < s.E; ++e) {
      const int r = s.row(e), cc = s.col(e), col = k0 + cc;
      ss[r * SS + cc] = mask.dead(mask.q_pos(q0 + r), mask.k_pos(col), col) ? -INFINITY : s.at(e) * scale;
    }
    wide_load<T, BK, kWideOc, LDO>(sv, vb, k0, Sk, c0, d);
    __syncthreads();
    {  // the online update: two threads a row, 32 keys each (lanes 2r and 2r + 1 of one warp)
      const int r = tid / 2, h = tid % 2;
      const float* srow = ss + r * SS + 32 * h;
      float mx = -INFINITY;
      for (int j = 0; j < 32; ++j) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sm[r], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = 0; j < 32; ++j) {
        const float x = srow[j], p = x == -INFINITY ? 0.f : expf(x - m_new);
        sum += p;
        sp[r * LDP + 32 * h + j] = wide_cast<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      __syncwarp();  // both lanes of the row have read sm[r]
      if (h == 0) {
        sm[r] = m_new;
        sl[r] = sl[r] * corr + sum;
        sc[r] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < o.E; ++e) o.at(e) *= sc[o.row(e)];
    o.add(RowMajor<T, LDP>{sp}, RowMajor<T, LDO>{sv}, BK);
  }
  __syncthreads();  // the last update of m and l (or their first values) is seen
#pragma unroll
  for (int e = 0; e < o.E; ++e) {
    const int r = o.row(e), row = q0 + r, col = c0 + o.col(e);
    if (row < Sq && col < d) out[(b * Sq + row) * d + col] = wide_cast<T>(o.at(e) / fmaxf(sl[r], 1e-30f));
  }
  if (c == 0 && tid < BQ && q0 + tid < Sq) {
    const float l = sl[tid];
    lse[b * Sq + q0 + tid] = l > 0.f ? sm[tid] + logf(l) : kNoMass;
  }
}

// Blocks of the wide grids: (rows, 64-row tiles, output chunks of ``oc`` columns)
int64_t wide_blocks(int64_t rows, int n, int d, int oc) { return tiles_of(rows, n) * ((int64_t(d) + oc - 1) / oc); }

template <typename T, typename Mask>
int wide_fwd_launch(const void* q, const void* k, const void* v, void* out, float* lse, int64_t bhq, int64_t bhk,
                    int d, float scale, Mask mask, cudaStream_t stream) {
  return launch(flash_wide_fwd_kernel<T, Mask>, wide_fwd_smem<T>(), kWideThreads,
                wide_blocks(bhq, mask.q_rows(), d, kWideOc), bhq, bhk, mask, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), lse, d,
                group_of(bhq, bhk), scale, mask);
}
