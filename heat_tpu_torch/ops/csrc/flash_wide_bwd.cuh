// The wide route's backward: dq and dk/dv at head dims past 256, included
// once by flash_attention_wide.cu inside flash_launch.cuh's anonymous
// namespace, before flash_wide.cuh (the forward, which runs on the
// clusters, tiles, ring and schedule defined here).
//
// Replaces, past d = 256, the Pallas TPU kernels of
// heat_tpu/ops/flash_attention.py:
//   flash_wide_dq_kernel  <- _flash_bwd_dq_kernel (l.339), grouped through
//                            _flash_gqa_bwd_impl (l.910, call l.924), and
//                            _flash_pos_bwd_dq_kernel (l.264)
//   flash_wide_dkv_kernel <- _flash_bwd_dkv_kernel (l.376), grouped through
//                            _flash_gqa_bwd_impl (call l.945), and
//                            _flash_pos_bwd_dkv_kernel (l.298)
// under StaticMask and PosMask, with GQA's K/V row map (K/V row b / g for
// query row b), as the d <= 256 bodies.
//
// Bound at (B*H, S, d) = (64, 1024, 512) causal on an H100 SXM: dq does
// 3 products of 2*BH*S^2*d/2 FLOP (103 GFLOP: 1.538 ms at 67 TFLOP/s
// float32, 0.104 ms at 989 TFLOP/s bf16), dk/dv 4 (137 GFLOP: 2.051 ms,
// 0.139 ms), against 671 and 805 MB of float32 inputs and outputs read
// and written once (0.200 and 0.240 ms at 3.35 TB/s): compute-bound in
// float32; in bfloat16 the bytes (336 and 403 MB: 0.100 and 0.120 ms) lie
// just below the products.
//
// A 64-row tile at d = 512 holds 128 KB of float32 accumulators (256 KB
// for dK and dV together), past one SM's registers, so a tile's output
// columns are split over blocks: a block of two warpgroups owns a chunk of C
// columns (C = 128 in bfloat16, 64 in float32) of one tile.  The three
// causes of the first design's slowness, and what this one does about each:
//
// 1. Recomputation: every chunk used to rebuild the 64 x 64 tiles S = Q K^T
//    and dP = dO V^T at full d.  Now the n_c blocks of one tile's chunks run
//    as one thread block cluster (cudaLaunchKernelEx with a cluster
//    dimension; blockIdx.x % n_c is the rank).  For each live tile pair each
//    block forms partial S and dP over its own d-columns only, writes them to
//    its shared memory, and after a cluster barrier reduces the rows
//    [rank * 64 / n_c, (rank + 1) * 64 / n_c) of every block's partials
//    through distributed shared memory (mapa), summing the ranks in order 0,
//    1, ..., so the result does not depend on which block sums.  It forms P
//    = exp(S * scale - lse) and dS = P (dP - dd) scale in float32 for those
//    rows, rounds them to the operand type (P to dO's, dS to K's and Q's, the
//    plain versions' rounding points) and stores them into every block's
//    shared memory; after a second barrier each block applies them to its
//    chunk: dq_c += dS K_c, or dV_c += P^T dO_c and dK_c += dS^T Q_c.  The
//    products executed per live pair are then the bound's: 3 for dq (S, dP,
//    dS.K, each once at full d), 4 for dk/dv.  The barriers are split into
//    arrive and wait (wb_schedule): the next pair's partial products run
//    while this pair's P and dS land.
//    A cluster holds at most 8 blocks (the portable limit).  Where d needs
//    more chunks, n_p = ceil(chunks / 8) clusters ("passes") share a tile,
//    each of n_c = ceil(chunks / n_p) blocks: pass p's block r owns chunk r +
//    n_c p and forms its partials over chunks r, r + n_c, ..., so each pass
//    covers all of d.  The score products are then repeated once a pass:
//    2 n_p + 1 products a live pair for dq and 2 n_p + 2 for dk/dv.  At d =
//    512 no route needs a second pass (clusters of 8 in float32, 4 in
//    bfloat16); at d = 1024 float32 takes 2, bfloat16 none.
// 2. Element-wise operand feed: bfloat16 products run on wgmma, a warpgroup
//    each: m64n64k16 for the partial scores (one warpgroup S, the other
//    dP), m64n64 for dq (each warpgroup 64 of the chunk's 128 columns) and
//    m64n128 for dV (one warpgroup) and dK (the other).  A and B are read by
//    descriptor from shared memory in the core-matrix layout without swizzle
//    that the TMA boxes write (8 rows of 16 bytes a core matrix); the same
//    tile is a K-major operand of the score products and, through the
//    descriptor's transpose bit, the MN-major B of dS.K, P^T.dO and dS^T.Q.
//    Float32 products run on the CUDA cores in full IEEE float32 (no TF32):
//    a thread owns an 8 x 4 patch (two warps a scheduler: 8 x 8 patches for
//    256 threads would not fit the registers beside the output's sums) and
//    reads float4s from row-major tiles padded to a stride of 4 mod 32 words,
//    free of bank conflicts for both the score products' and the outputs'
//    reads.
// 3. Synchronous loads: a tile pair's partner tiles (dq: K, V; dk/dv: Q,
//    dO) arrive in a ring of two stages, each with an mbarrier, loaded one
//    pair ahead: pair n + 2's load is issued when pair n's output products
//    end, so it lands during pair n + 1.  Bfloat16 rows of whole 16-byte
//    chunks come by TMA (cp.async.bulk.tensor boxes of 8 columns by 64 rows,
//    zeros past the rows and d), one thread arming the barrier with the
//    bytes; float32 rows by 16-byte cp.async that arrive on the barrier
//    (cp.async.mbarrier.arrive.noinc).  Rows off 16 bytes take element
//    copies; a pair's later chunks, where d takes passes, are loaded as
//    they are needed.
//
// Every output element is written by one block, with no atomics, and every
// sum runs in a fixed order, so runs repeat bit for bit.  A block whose
// tile has no live pair writes zeros.  A cluster that cannot be placed
// (its size or shared memory) fails its launch, which the launcher reports.

constexpr int kWbThreads = 256;   // a block: two warpgroups
constexpr int kWbMaxCluster = 8;  // blocks a cluster: the portable limit
constexpr int kWbRld = 64 + 4;    // stride, in floats, of a float32 64 x 64 tile (partial sums; float32 P, dS)

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

// output columns of a block: bfloat16 128 (a warpgroup's wgmma m64n64
// half of dq, or all of dV or dK by m64n128), float32 64
template <typename T, bool DKV>
constexpr int kWbC = std::is_same_v<T, __nv_bfloat16> ? 128 : 64;

// The split of d: ``no`` chunks of C columns, ``nc`` blocks a cluster, ``np`` passes.
struct WidePlan {
  int no, nc, np;
};
__host__ __device__ __forceinline__ WidePlan wide_plan(int d, int C) {
  const int no = (d + C - 1) / C, np = (no + kWbMaxCluster - 1) / kWbMaxCluster;
  return {no, (no + np - 1) / np, np};
}

// A 64-row operand tile of C columns:
// - bfloat16: the layout TMA boxes of 8 columns by 64 rows write, one box
//   after another: wgmma's core-matrix layout without swizzle (8 rows of 16
//   bytes a core matrix), row octets 128 bytes apart, column octets 1 KB apart.
// - float32: row-major with a stride of C + 4 (4 mod 32 words), so the
//   patches' float4 reads of 8 rows at one column, and of one row at 8
//   columns, fall on distinct banks.  (TMA writes no padding; with its
//   128-byte swizzle these products ran slower on an H100.)
constexpr int kWbBox = 8;  // columns of a bfloat16 TMA box
template <typename T, int C>
struct WbTile {
  static constexpr bool F32 = std::is_same_v<T, float>;
  static constexpr int LD = F32 ? C + 4 : C;
  static constexpr int BYTES = 64 * LD * int(sizeof(T));
  __device__ __forceinline__ static int at(int r, int c) {
    return F32 ? r * LD + c : ((c >> 3) * 64 + r) * 8 + (c & 7);
  }
};
// The pushed P and dS tiles (64 x 64), laid out as an operand tile.
template <typename T>
using WbPushed = WbTile<T, 64>;

// The shared memory of a block, in bytes from its start rounded up to 1 KB:
// the own tiles (2), the ring (2 stages of 2 partner
// tiles), the partial S and dP (float32) of each stage, the pushed P and dS
// (dq: dS; dk/dv: P^T then dS^T: the output products' A operand), lse and
// dd (64 floats each; dk/dv one pair a stage), and the ring's two
// mbarriers; BYTES counts the rounding.
template <typename T, bool DKV>
struct WbSmem {
  static constexpr bool F32 = std::is_same_v<T, float>;
  static constexpr int C = kWbC<T, DKV>, TILE = WbTile<T, C>::BYTES;
  static constexpr int NR = DKV ? 2 : 1;  // pushed tiles
  static constexpr int RED = 64 * kWbRld * 4, PUSHED = WbPushed<T>::BYTES;
  static constexpr int STAGE = 2 * TILE, RED_OFF = STAGE + 4 * TILE, PUSHED_OFF = RED_OFF + 4 * RED,
                       ROWS_OFF = PUSHED_OFF + NR * PUSHED, BAR_OFF = ROWS_OFF + NR * 128 * 4,
                       BYTES = BAR_OFF + 2 * 8 + 1024;
};
// the block's shared memory from its dynamic base, rounded up to 1 KB (by
// pointer arithmetic, so the compiler still knows the pointer shared)
__device__ __forceinline__ char* wb_smem_base(float4* dyn) {
  return reinterpret_cast<char*>(dyn) + ((1024u - (smem_u32(dyn) & 1023u)) & 1023u);
}


// ---- cluster, mbarrier and proxy primitives ----

// the address of ``p`` (this block's shared memory) in the shared memory of cluster rank ``rank``
template <typename P>
__device__ __forceinline__ P* wb_map(P* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<P*>(out);
}
__device__ __forceinline__ void wb_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// ASYNC: the thread's cp.async so far arrive on ``bar`` as they land; else it arrives now
template <bool ASYNC>
__device__ __forceinline__ void wb_bar_arrive(uint64_t* bar) {
  if constexpr (ASYNC)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
  else
    asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void wb_bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// stage barrier ``bar`` expects ``bytes`` more from TMA this phase (and counts this arrival)
__device__ __forceinline__ void wb_bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// one TMA box of the 3-D view (d, rows, batch) at (c, r, b) into dst, completing on bar
__device__ __forceinline__ void wb_tma(void* dst, const CUtensorMap* map, int c, int r, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(b), "r"(smem_u32(bar))
      : "memory");
}
// a bfloat16 64 x C tile of rows [r0, r0 + 64) and columns [c0, c0 + C) of
// batch row b through TMA boxes; the caller counts its bytes on bar.  Rows
// past the view's rows and columns past d arrive as zeros.
template <int C>
__device__ __forceinline__ void wb_tma_tile(__nv_bfloat16* dst, const CUtensorMap* map, int c0, int r0, int b,
                                            uint64_t* bar) {
#pragma unroll
  for (int i = 0; i < C / kWbBox; ++i) wb_tma(dst + 64 * kWbBox * i, map, c0 + kWbBox * i, r0, b, bar);
}

// the thread's shared-memory writes so far are seen by wgmma (the async proxy)
__device__ __forceinline__ void wb_fence_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wb_cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Rows [r0, r0 + 64) and columns [c0, c0 + C) of a row-major (rows, d)
// matrix into tile ``dst`` by the threads, zero past the rows and past d:
// the loads a tile pair needs past its first chunk (passes), and every load
// where rows are not whole 16-byte chunks.  VEC: 16-byte cp.async; else
// float32 by 4-byte cp.async, bfloat16 by plain copies.
template <typename T, int C, bool VEC>
__device__ __forceinline__ void wb_load(T* dst, const T* __restrict__ src, int r0, int rows, int c0, int d) {
  using L = WbTile<T, C>;
  if constexpr (VEC) {
    constexpr int E = 16 / int(sizeof(T)), CH = C / E;  // elements a chunk, chunks a row
    for (int e = int(threadIdx.x); e < 64 * CH; e += kWbThreads) {  // float32 along rows, bfloat16 down columns
      const int r = L::F32 ? e / CH : e % 64, ch = L::F32 ? e % CH : e / 64;
      const int gr = r0 + r, gc = c0 + ch * E;
      const bool ok = gr < rows && gc < d;
      cp_async_16(smem_u32(dst + L::at(r, ch * E)), ok ? src + int64_t(gr) * d + gc : src, ok);
    }
  } else {
    for (int e = int(threadIdx.x); e < 64 * C; e += kWbThreads) {
      const int r = e / C, c = e % C, gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rows && gc < d;
      if constexpr (L::F32)
        cp_async_4(smem_u32(dst + L::at(r, c)), ok ? src + int64_t(gr) * d + gc : src, ok);
      else
        dst[L::at(r, c)] = ok ? src[int64_t(gr) * d + gc] : wide_cast<T>(0.f);
    }
    if constexpr (!L::F32) wb_fence_async();
  }
}

// float32 rows [r0, r0 + BQ) of one (rows,) vector into dst, 0 past the rows
__device__ __forceinline__ void wide_load_rows(float* dst, const float* __restrict__ src, int r0, int rows) {
  if (threadIdx.x < BQ) dst[threadIdx.x] = r0 + int(threadIdx.x) < rows ? src[r0 + threadIdx.x] : 0.f;
}

// ---- float32 products on the CUDA cores ----

// acc[i][j] += sum over kk < K of a[rg + 8i][kk] b[cg + 16j][kk]: operand tiles (WbTile<float, C>)
template <int C, int K = C>
__device__ __forceinline__ void f32_nt(float (&acc)[8][4], const float* a, const float* b, int rg, int cg) {
  constexpr int LD = WbTile<float, C>::LD;
#pragma unroll 1
  for (int kk = 0; kk < K; kk += 4) {
    float4 bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (cg + 16 * j) * LD + kk);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(a + (rg + 8 * i) * LD + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum over kk in [k0, k0 + K) of a[rg + 8i][kk] b[kk][4 cg + j]:
// a a pushed tile (WbPushed<float>), b an operand tile (WbTile<float, C>)
template <int C, int K>
__device__ __forceinline__ void f32_nn(float (&acc)[8][4], const float* a, const float* b, int rg, int cg, int k0) {
  constexpr int LDA = WbPushed<float>::LD, LDB = WbTile<float, C>::LD;
#pragma unroll 1
  for (int kk = k0; kk < k0 + K; kk += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(a + (rg + 8 * i) * LDA + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 bv = *reinterpret_cast<const float4*>(b + (kk + u) * LDB + 4 * cg);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = u == 0 ? av[i].x : u == 1 ? av[i].y : u == 2 ? av[i].z : av[i].w;
        acc[i][0] = fmaf(x, bv.x, acc[i][0]);
        acc[i][1] = fmaf(x, bv.y, acc[i][1]);
        acc[i][2] = fmaf(x, bv.z, acc[i][2]);
        acc[i][3] = fmaf(x, bv.w, acc[i][3]);
      }
    }
  }
}

// ---- bfloat16 products on wgmma ----

// a descriptor of a core-matrix tile without swizzle: ``lbo`` bytes between
// core matrices along K, ``sbo`` along M or N
__device__ __forceinline__ uint64_t wb_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3ffff) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}
__device__ __forceinline__ void wb_wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wb_wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wb_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (+)= a b, m64n64k16 bf16 -> float32; TB: B read MN-major; acc = 0: d = a b
template <int TB>
__device__ __forceinline__ void wb_mma64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TB)
      : "memory");
}
// d (+)= a b, m64n128k16 bf16 -> float32, B read MN-major; acc = 0: d = a b
__device__ __forceinline__ void wb_mma128t(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}
// row and column of accumulator register r of an m64nN fragment in this thread's warpgroup
__device__ __forceinline__ int wb_row(int r) {
  return 16 * (int(threadIdx.x % 128) / 32) + int(threadIdx.x % 32) / 4 + 8 * ((r >> 1) & 1);
}
__device__ __forceinline__ int wb_col(int r) { return 8 * (r >> 2) + 2 * int(threadIdx.x % 4) + (r & 1); }

// ---- the accumulators of a block and its products ----
//
// The block's two halves (warpgroups, threads [128 h, 128 h + 128)) split
// every product in two.  partial(x0, y0, x1, y1, red_s, red_dp, first): the
// partial scores over this chunk's columns, half 0 x0 y0^T into red_s, half
// 1 x1 y1^T into red_dp (dq: Q_j K_j^T and dO_j V_j^T; dk/dv: K_j Q_j^T and
// V_j dO_j^T), stored for the tile pair's first chunk and added after it (a
// block's chunks when d takes passes), so no score sum stays in registers
// past its products.  output(a0, b0, a1, b1): the chunk's output; dk/dv:
// half 0 dV += P^T dO_o (a0, b0), half 1 dK += dS^T Q_o (a1, b1); dq (a0 =
// dS, b0 = K_o): bfloat16 half h the columns [64 h, 64 h + 64), float32
// half h the keys [32 h, 32 h + 32) of every column, the halves added at
// the end (``finish``).

template <typename T, bool DKV>
struct WbAcc;

// float32: thread lt = t % 128 of half h owns rows rg + 8 i (rg = lt / 16)
// of each 64-row tile: columns cg + 16 j (cg = lt % 16) of a score tile,
// columns 4 cg + {0..3} of the output's.
template <bool DKV>
struct WbAcc<float, DKV> {
  static constexpr int C = 64;
  float o[8][4];
  int h, rg, cg;
  __device__ __forceinline__ WbAcc()
      : h(int(threadIdx.x) / 128), rg((int(threadIdx.x) % 128) / 16), cg(int(threadIdx.x) % 16) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }
  __device__ __forceinline__ void partial(const float* x0, const float* y0, const float* x1, const float* y1,
                                          float* red_s, float* red_dp, bool first) const {
    float ps[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[i][j] = 0.f;
    f32_nt<C>(ps, h ? x1 : x0, h ? y1 : y0, rg, cg);
    float* red = h ? red_dp : red_s;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float& r = red[(rg + 8 * i) * kWbRld + cg + 16 * j];
        r = first ? ps[i][j] : r + ps[i][j];
      }
  }
  __device__ __forceinline__ void output(const float* a0, const float* b0, const float* a1, const float* b1) {
    if constexpr (DKV)
      f32_nn<C, 64>(o, h ? a1 : a0, h ? b1 : b0, rg, cg, 0);
    else
      f32_nn<C, 32>(o, a0, b0, rg, cg, 32 * h);
  }
  // dq: half 1 hands its sums to half 0 through ``scratch`` (64 x kWbRld
  // floats no other block reads any more), which adds them in that order.
  // Called by every thread.
  __device__ __forceinline__ void finish(float* scratch) {
    if constexpr (!DKV) {
      if (h == 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float4*>(scratch + (rg + 8 * i) * kWbRld + 4 * cg) =
              make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
      }
      __syncthreads();
      if (h == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(scratch + (rg + 8 * i) * kWbRld + 4 * cg);
          o[i][0] += x.x;
          o[i][1] += x.y;
          o[i][2] += x.z;
          o[i][3] += x.w;
        }
      }
    }
  }
  // write the chunk: out(row, col) = the element at tile row ``row``, chunk column ``col``
  template <bool VEC, typename Out>
  __device__ __forceinline__ void store(const Out& out) const {
    if (!DKV && h == 1) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) out.template put4<VEC>(rg + 8 * i, 4 * cg, o[i], h);
  }
};

// bfloat16: each warpgroup's fragments; the partial scores m64n64; the
// output dq m64n64 (its 64 columns of the chunk), dV or dK m64n128
template <bool DKV>
struct WbAcc<__nv_bfloat16, DKV> {
  using B16 = __nv_bfloat16;
  static constexpr int C = kWbC<B16, DKV>, NE = DKV ? 64 : 32;
  float o[NE];
  int h;
  __device__ __forceinline__ WbAcc() : h(int(threadIdx.x) / 128) {
#pragma unroll
    for (int i = 0; i < NE; ++i) o[i] = 0.f;
  }
  __device__ __forceinline__ void partial(const B16* x0, const B16* y0, const B16* x1, const B16* y1, float* red_s,
                                          float* red_dp, bool first) const {
    const B16* x = h ? x1 : x0;
    const B16* y = h ? y1 : y0;
    float s[32];
    wb_wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks)  // K-major A and B: column octets 1 KB apart, k-steps 2 KB
      wb_mma64<0>(s, wb_desc(x + 1024 * ks, 1024, 128), wb_desc(y + 1024 * ks, 1024, 128), ks > 0);
    wb_wgmma_commit_wait();
    wb_hold(s);
    float* red = h ? red_dp : red_s;
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      float2& a = *reinterpret_cast<float2*>(red + wb_row(r) * kWbRld + wb_col(r));
      a = first ? make_float2(s[r], s[r + 1]) : make_float2(a.x + s[r], a.y + s[r + 1]);
    }
  }
  // a: a pushed 64 x 64 tile (K-major, k-steps 2 KB apart); b: the chunk's
  // tile read MN-major (row octets, along K, 128 bytes apart: k-steps 256
  // bytes; column octets 1 KB apart)
  __device__ __forceinline__ void output(const B16* a0, const B16* b0, const B16* a1, const B16* b1) {
    wb_wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if constexpr (DKV) {
        const B16* a = h ? a1 : a0;
        const B16* b = h ? b1 : b0;
        wb_mma128t(o, wb_desc(a + 1024 * ks, 1024, 128), wb_desc(b + 128 * ks, 128, 1024), 1);
      } else {  // columns [64 h, 64 h + 64): 8 column octets on
        wb_mma64<1>(o, wb_desc(a0 + 1024 * ks, 1024, 128), wb_desc(b0 + 128 * ks + 4096 * h, 128, 1024), 1);
      }
    }
    wb_wgmma_commit_wait();
    wb_hold(o);
  }
  __device__ __forceinline__ void finish(float*) {}
  template <bool VEC, typename Out>
  __device__ __forceinline__ void store(const Out& out) const {
#pragma unroll
    for (int r = 0; r < NE; r += 2)
      out.template put2<VEC>(wb_row(r), wb_col(r) + (DKV ? 0 : 64 * h), &o[r], DKV ? h : 0);
  }
};

// Where a block writes its chunk: rows [r0, r0 + 64) of its batch row's
// (rows, d) output (dq; dk/dv: dst0 = dV, dst1 = dK), columns from c0; ``which`` picks dst0
// (0) or dst1 (1).  Float32 takes float4 stores and bfloat16 pairs where
// VEC, element stores otherwise.
template <typename T>
struct WbOut {
  T* dst0;
  T* dst1;
  int r0, rows, c0, d;
  template <bool VEC>
  __device__ __forceinline__ void put4(int r, int c, const float* v, int which) const {
    const int gr = r0 + r, gc = c0 + c;
    if (gr >= rows) return;
    T* p = (which ? dst1 : dst0) + int64_t(gr) * d + gc;
    if constexpr (VEC && std::is_same_v<T, float>) {
      if (gc < d) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (gc + u < d) p[u] = wide_cast<T>(v[u]);
    }
  }
  template <bool VEC>
  __device__ __forceinline__ void put2(int r, int c, const float* v, int which) const {
    const int gr = r0 + r, gc = c0 + c;
    if (gr >= rows) return;
    T* p = (which ? dst1 : dst0) + int64_t(gr) * d + gc;
    if constexpr (VEC && !std::is_same_v<T, float>) {
      if (gc < d) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (gc + u < d) p[u] = wide_cast<T>(v[u]);
    }
  }
};

// p = exp(s * scale - lse) and dS = p (dP - dd) scale of one score element,
// 0 where the key is masked or the query row lies past the rows
template <typename Mask>
__device__ __forceinline__ float2 wide_p_ds(const Mask& mask, float s, float dp, float lse, float dd, float scale,
                                            int row, int col) {
  if (row >= mask.q_rows() || mask.dead(mask.q_pos(row), mask.k_pos(col), col)) return make_float2(0.f, 0.f);
  const float p = p_of(s, scale, lse);
  return make_float2(p, __fmul_rn(__fmul_rn(p, __fsub_rn(dp, dd)), scale));
}

__device__ __forceinline__ void wb_store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void wb_store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// The cluster's exchange for one tile pair, between the two cluster
// barriers: this block's rows [rank * 64 / nc, (rank + 1) * 64 / nc) of S and
// dP, summed over the ranks' partials in rank order, give P and dS, which
// go rounded to T into the pushed tiles of every block (dq: dS; dk/dv: P^T,
// then dS^T).  Rows are queries for dq and keys for dk/dv; the tile's lse
// and dd are indexed by its queries.  Bfloat16 tiles are read by wgmma,
// through the async proxy: the stores are fenced for it here, and the
// reader fences again after the barrier (wb_pushed_ready).
template <typename T, bool DKV, typename Mask>
__device__ __forceinline__ void wb_exchange(const float* red_s, const float* red_dp, T* pushed, const float* slse,
                                            const float* sdd, int nc, int rank, const Mask& mask, float scale, int q0,
                                            int k0) {
  using L = WbPushed<T>;
  const int lo = rank * 64 / nc, n4 = ((rank + 1) * 64 / nc - lo) * 16;
  for (int f = int(threadIdx.x); f < n4; f += kWbThreads) {
    const int r = lo + f / 16, c = (f % 16) * 4, at = r * kWbRld + c;
    float4 a[kWbMaxCluster], e[kWbMaxCluster];  // every rank's loads in flight at once
#pragma unroll
    for (int j = 0; j < kWbMaxCluster; ++j)
      if (j < nc) {
        a[j] = *reinterpret_cast<const float4*>(wb_map(red_s, j) + at);
        e[j] = *reinterpret_cast<const float4*>(wb_map(red_dp, j) + at);
      }
    float4 s = a[0], dp = e[0];
#pragma unroll
    for (int j = 1; j < kWbMaxCluster; ++j)
      if (j < nc) {
        s = make_float4(s.x + a[j].x, s.y + a[j].y, s.z + a[j].z, s.w + a[j].w);
        dp = make_float4(dp.x + e[j].x, dp.y + e[j].y, dp.z + e[j].z, dp.w + e[j].w);
      }
    const float sv[4] = {s.x, s.y, s.z, s.w}, dv[4] = {dp.x, dp.y, dp.z, dp.w};
    float pt[4], dt[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int qi = DKV ? c + u : r, ki = DKV ? r : c + u;
      const float2 pd = wide_p_ds(mask, sv[u], dv[u], slse[qi], sdd[qi], scale, q0 + qi, k0 + ki);
      pt[u] = pd.x;
      dt[u] = pd.y;
    }
    for (int j = 0; j < nc; ++j) {  // four consecutive columns: 16 or 8 contiguous bytes in either layout
      T* dst = wb_map(pushed, j) + L::at(r, c);
      if constexpr (DKV) wb_store4(dst, pt);
      wb_store4(dst + (DKV ? L::BYTES / int(sizeof(T)) : 0), dt);
    }
  }
  if constexpr (!std::is_same_v<T, float>) asm volatile("fence.proxy.async;\n" ::: "memory");
}

// After the exchange's second cluster barrier: the pushed bfloat16 tiles
// are read by wgmma (the async proxy) from here on.
template <typename T>
__device__ __forceinline__ void wb_pushed_ready() {
  if constexpr (!std::is_same_v<T, float>) wb_fence_async();
}

__device__ __forceinline__ void wb_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wb_cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// A block's chunks: rank r forms its partial scores over chunks r + nc (s -
// 1) for steps s = 1, ..., np, those below ``no``, in that order in every
// pass (so every pass sums the same bits and forms the same P and dS); its
// own chunk, r + nc p in pass p, is step p + 1.
struct WbSteps {
  WidePlan pl;
  int rank, pass;
  __device__ __forceinline__ int chunk(int s) const { return rank + pl.nc * (s - 1); }
  // the step after s with a chunk below no; np + 1: none
  __device__ __forceinline__ int next(int s) const {
    do ++s;
    while (s <= pl.np && chunk(s) >= pl.no);
    return s;
  }
  __device__ __forceinline__ int own() const { return pass + 1; }
  __device__ __forceinline__ bool owns() const { return chunk(own()) < pl.no; }
};

// The fields the kernels share: shared memory (laid out by M), the plan,
// the ring's barriers.  The ring's stage st holds a partner tile's two
// operand tiles (dq and the forward: K, V; dk/dv: Q, dO) at ring + 2 st TE;
// red(st) its partial S and dP (the forward: the two warpgroups' partial S).
template <typename T, bool DKV, typename M_ = WbSmem<T, DKV>>
struct WbBlock {
  using M = M_;
  static constexpr int C = M::C, TE = M::TILE / int(sizeof(T));  // tile elements
  T* res;  // the own tiles (dq: Q_j, dO_j; dk/dv: K_j, V_j; the forward: Q_j)
  T* ring;
  float* red;
  T* pushed;
  float* rows;  // lse, dd: dq one set; dk/dv one a stage; the forward: m, l, corr
  uint64_t* bar;
  WbSteps steps;
  uint32_t phase = 0;
  __device__ __forceinline__ WbBlock(char* sb, const WidePlan& pl, int rank, int pass)
      : res(reinterpret_cast<T*>(sb)),
        ring(reinterpret_cast<T*>(sb + M::STAGE)),
        red(reinterpret_cast<float*>(sb + M::RED_OFF)),
        pushed(reinterpret_cast<T*>(sb + M::PUSHED_OFF)),
        rows(reinterpret_cast<float*>(sb + M::ROWS_OFF)),
        bar(reinterpret_cast<uint64_t*>(sb + M::BAR_OFF)),
        steps{pl, rank, pass} {}
  __device__ __forceinline__ T* stage(int st) const { return ring + 2 * st * TE; }
  __device__ __forceinline__ float* red_s(int st) const { return red + 2 * st * 64 * kWbRld; }
  __device__ __forceinline__ float* red_dp(int st) const { return red_s(st) + 64 * kWbRld; }
  // wait for stage st's asynchronous loads (its first item)
  __device__ __forceinline__ void wait_stage(int st) {
    wb_bar_wait(bar + st, (phase >> st) & 1u);
    phase ^= 1u << st;
    if constexpr (!M::F32) wb_fence_async();
  }
};

// A partner tile's partial scores into red(st): its first item from stage
// st (loaded ahead by ``k.issue``), later items (passes) loaded here; then
// stage st holds the block's own chunk for the output products.
template <typename K>
__device__ __forceinline__ void wb_partials(K& k, int part, int st) {
  const WbSteps& steps = k.blk.steps;
  int last = 0;
  for (int s = steps.next(0), first = 1; s <= steps.pl.np; last = s, s = steps.next(s), first = 0) {
    if (steps.pl.np > 1) k.load_own(s);  // this chunk's own tiles, synchronously
    if (first) {
      k.rows(part, st);
      k.blk.wait_stage(st);
    } else {
      k.load_partner_now(part, s, st);
    }
    k.partial(st, first);
  }
  if (last != steps.own() && steps.owns()) k.load_partner_now(part, steps.own(), st);
}

// Where a block's time goes, when the unit is built with -DHEAT_WB_PHASES
// (scripts/wide_phases.py; otherwise every call is empty): thread 0 of
// each block adds the clock cycles of each phase of wb_schedule, and the
// tile pairs it ran, to wb_phase_cycles[kind][phase] (heat_wb_phases; kind
// 0 dq, 1 dk/dv, 2 the forward).
enum WbPhase { kPhIssue, kPhWait1, kPhExchange, kPhArrive2, kPhPartials, kPhWait2, kPhOutput, kPhBarrier,
               kPhArrive1, kPhPairs };
#ifdef HEAT_WB_PHASES
constexpr int kPhKinds = 3;
__device__ unsigned long long wb_phase_cycles[kPhKinds][kPhPairs + 1];
struct WbPhases {
  long long t, c[kPhPairs + 1] = {};
  __device__ __forceinline__ WbPhases() { t = clock64(); }
  __device__ __forceinline__ void mark(int k) {
    const long long now = clock64();
    c[k] += now - t;
    t = now;
  }
  __device__ __forceinline__ void count() { ++c[kPhPairs]; }
  __device__ __forceinline__ void flush(int kind) const {
    if (threadIdx.x == 0)
      for (int k = 0; k <= kPhPairs; ++k) atomicAdd(&wb_phase_cycles[kind][k], (unsigned long long)c[k]);
  }
};
#else
struct WbPhases {
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void count() {}
  __device__ __forceinline__ void flush(int) const {}
};
#endif

// The schedule of the wide kernels.  Every block of a cluster runs it in step
// over the same partner tiles; the two cluster barriers of a tile pair are
// split into arrive and wait, so the next pair's partial products run
// while this pair's pushes land:
//   partials(0); arrive
//   for each partner n:
//     wait                  the cluster's partial scores of n are in place
//     exchange(n); arrive
//     partials(n + 1)       into the other red and from the other stage
//     wait                  every block's P and dS of n are in place
//     output(n); barrier; arrive; load partner n + 2's tiles into n's stage
template <typename K>
__device__ __forceinline__ void wb_schedule(K& k) {
  WbPhases ph;
  int cur = k.next_live(0);
  if (cur >= k.end) return;
  k.issue(cur, 0, k.blk.steps.pl.np == 1);  // with the own tiles, once, where the tile takes one pass
  wb_partials(k, cur, 0);
  int nxt = k.next_live(cur + 1);
  if (nxt < k.end) k.issue(nxt, 1, false);
  wb_cluster_arrive();
  for (int n = 0; cur < k.end; ++n) {
    const int st = n & 1;
    ph.mark(kPhIssue);
    wb_cluster_wait();
    ph.mark(kPhWait1);
    k.exchange(cur, st);
    ph.mark(kPhExchange);
    wb_cluster_arrive();
    ph.mark(kPhArrive2);
    int after = k.end;
    if (nxt < k.end) {
      wb_partials(k, nxt, st ^ 1);
      after = k.next_live(nxt + 1);
    }
    ph.mark(kPhPartials);
    wb_cluster_wait();
    ph.mark(kPhWait2);
    wb_pushed_ready<typename K::T>();
    if (k.blk.steps.owns()) k.output(st);
    ph.mark(kPhOutput);
    __syncthreads();  // stage st is free
    ph.mark(kPhBarrier);
    if (nxt < k.end) {
      wb_cluster_arrive();
      ph.mark(kPhArrive1);
      if (after < k.end) k.issue(after, st, false);
    }
    cur = nxt;
    nxt = after;
    ph.count();
  }
  ph.flush(K::KIND);
}

// dq's view of the schedule: block (b, query tile, pass p, rank r) of a
// cluster of nc blocks writes dq[b, tile, chunk r + nc p], summed over the
// live key tiles (the partners).
template <typename T_, bool VEC, typename Mask>
struct WbDq {
  static constexpr int KIND = 0;
  using T = T_;
  using B = WbBlock<T, false>;
  static constexpr int C = B::C, TE = B::TE;
  static constexpr bool ASYNC = VEC || B::M::F32, TMA = VEC && !B::M::F32;
  B blk;
  WbAcc<T, false> acc;
  const T *qb, *dob, *kb, *vb;
  const CUtensorMap *mq, *mk, *mv, *mdo;  // VEC: TMA views of q, k, v, dO
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
    const int c0 = blk.steps.chunk(s) * C;
    wb_load<T, C, VEC>(blk.res, qb, q0, Sq, c0, d);
    wb_load<T, C, VEC>(blk.res + TE, dob, q0, Sq, c0, d);
  }
  __device__ __forceinline__ void load_partner_async(int it, int s, int st) {
    const int c0 = blk.steps.chunk(s) * C;
    wb_load<T, C, VEC>(blk.stage(st), kb, it * BK, Sk, c0, d);
    wb_load<T, C, VEC>(blk.stage(st) + TE, vb, it * BK, Sk, c0, d);
  }
  // key tile it's first item into stage st (with the own tiles), on the
  // stage's barrier: bfloat16 rows of whole 16-byte chunks by TMA from one
  // thread, the rest by every thread
  __device__ __forceinline__ void issue(int it, int st, bool own_too) {
    const int s = blk.steps.next(0);
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        const int c0 = blk.steps.chunk(s) * C;
        uint64_t* bar = blk.bar + st;
        wb_bar_expect(bar, (own_too ? 4 : 2) * B::M::TILE);
        if (own_too) {
          wb_tma_tile<C>(blk.res, mq, c0, q0, b, bar);
          wb_tma_tile<C>(blk.res + TE, mdo, c0, q0, b, bar);
        }
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
    __syncthreads();  // the last partial's reads of the own tiles are done
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
    acc.partial(blk.res, blk.stage(st), blk.res + TE, blk.stage(st) + TE, blk.red_s(st), blk.red_dp(st), first);
  }
  __device__ __forceinline__ void exchange(int it, int st) {
    wb_exchange<T, false>(blk.red_s(st), blk.red_dp(st), blk.pushed, blk.rows, blk.rows + 64, blk.steps.pl.nc,
                          blk.steps.rank, mask, scale, q0, it * BK);
  }
  __device__ __forceinline__ void output(int st) { acc.output(blk.pushed, blk.stage(st), nullptr, nullptr); }
};

template <typename T, bool VEC, typename Mask>
__global__ void __launch_bounds__(kWbThreads, 1)
    flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
                         T* __restrict__ dq, int d, int g, float scale, Mask mask, const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo) {
  extern __shared__ float4 smem4[];
  const int Sq = mask.q_rows(), Sk = mask.k_rows();
  const WidePlan pl = wide_plan(d, kWbC<T, false>);
  const int nq = (Sq + BQ - 1) / BQ, rank = int(blockIdx.x % pl.nc);
  const int64_t cl = blockIdx.x / pl.nc;
  const int pass = int(cl % pl.np), iq = int((cl / pl.np) % nq);
  const int64_t b = (cl / pl.np) / nq;
  const int q0 = iq * BQ;
  WbDq<T, VEC, Mask> kern{WbBlock<T, false>(wb_smem_base(smem4), pl, rank, pass),
                          WbAcc<T, false>(),
                          q + b * Sq * d,
                          dout + b * Sq * d,
                          k + (b / g) * Sk * d,
                          v + (b / g) * Sk * d,
                          &mq,
                          &mk,
                          &mv,
                          &mdo,
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
  if (threadIdx.x == 0) {  // TMA: one arrival and the bytes; else every thread's
    wb_bar_init(kern.blk.bar, kern.TMA ? 1 : kWbThreads);
    wb_bar_init(kern.blk.bar + 1, kern.TMA ? 1 : kWbThreads);
  }
  wide_load_rows(kern.blk.rows, lse + b * Sq, q0, Sq);
  wide_load_rows(kern.blk.rows + 64, dd + b * Sq, q0, Sq);
  __syncthreads();
  wb_schedule(kern);
  kern.acc.finish(kern.blk.red);
  if (kern.blk.steps.owns())
    kern.acc.template store<VEC>(WbOut<T>{dq + b * Sq * d, dq + b * Sq * d, q0, Sq, (rank + pl.nc * pass) * kern.C, d});
}

// dk/dv's view: block (K/V row bk, key tile, pass p, rank r) writes dk and
// dv[bk, tile, chunk r + nc p], summed over the g query rows of its group
// and their live query tiles: the partners, part = j nq + iq for query head
// j < g and query tile iq.
template <typename T_, bool VEC, typename Mask>
struct WbDkv {
  static constexpr int KIND = 1;
  using T = T_;
  using B = WbBlock<T, true>;
  static constexpr int C = B::C, TE = B::TE;
  static constexpr bool ASYNC = VEC || B::M::F32, TMA = VEC && !B::M::F32;
  B blk;
  WbAcc<T, true> acc;
  const T *q, *dout, *kb, *vb;
  const CUtensorMap *mq, *mk, *mv, *mdo;  // VEC: TMA views of q, k, v, dO
  const float *lse, *dd;
  const Mask& mask;
  float scale;
  int64_t bk;
  int Sq, Sk, d, g, nq, k0, qbeg, end;
  int2 keys;
  // the query row of partner part: head part / nq of K/V row bk's group
  __device__ __forceinline__ int64_t qrow(int part) const { return bk * g + part / nq; }
  __device__ __forceinline__ int next_live(int part) const {
    for (; part < end; ++part) {
      if (part % nq < qbeg) part += qbeg - part % nq;
      if (part >= end) break;
      if (mask.fwd_block_live(keys, mask.query_bound((part % nq) * BQ))) break;
    }
    return min(part, end);
  }
  __device__ __forceinline__ void load_own_async(int s) {
    const int c0 = blk.steps.chunk(s) * C;
    wb_load<T, C, VEC>(blk.res, kb, k0, Sk, c0, d);
    wb_load<T, C, VEC>(blk.res + TE, vb, k0, Sk, c0, d);
  }
  __device__ __forceinline__ void load_partner_async(int part, int s, int st) {
    const int64_t bq = qrow(part);
    const int c0 = blk.steps.chunk(s) * C, q0 = (part % nq) * BQ;
    wb_load<T, C, VEC>(blk.stage(st), q + bq * Sq * d, q0, Sq, c0, d);
    wb_load<T, C, VEC>(blk.stage(st) + TE, dout + bq * Sq * d, q0, Sq, c0, d);
  }
  __device__ __forceinline__ void issue(int part, int st, bool own_too) {
    const int s = blk.steps.next(0);
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        const int c0 = blk.steps.chunk(s) * C, q0 = (part % nq) * BQ, bq = int(qrow(part));
        uint64_t* bar = blk.bar + st;
        wb_bar_expect(bar, (own_too ? 4 : 2) * B::M::TILE);
        if (own_too) {
          wb_tma_tile<C>(blk.res, mk, c0, k0, int(bk), bar);
          wb_tma_tile<C>(blk.res + TE, mv, c0, k0, int(bk), bar);
        }
        wb_tma_tile<C>(blk.stage(st), mq, c0, q0, bq, bar);
        wb_tma_tile<C>(blk.stage(st) + TE, mdo, c0, q0, bq, bar);
      }
    } else {
      if (own_too) load_own_async(s);
      load_partner_async(part, s, st);
      wb_bar_arrive<ASYNC>(blk.bar + st);
    }
  }
  __device__ __forceinline__ void sync_loads() {  // and order them before the next TMA writes
    wb_cp_async_wait_all();
    wb_fence_async();
    __syncthreads();
  }
  __device__ __forceinline__ void load_own(int s) {
    __syncthreads();
    load_own_async(s);
    sync_loads();
  }
  __device__ __forceinline__ void load_partner_now(int part, int s, int st) {
    __syncthreads();
    load_partner_async(part, s, st);
    sync_loads();
  }
  // the query tile's lse and dd into stage st's rows, read by its exchange
  __device__ __forceinline__ void rows(int part, int st) {
    const int64_t bq = qrow(part);
    const int q0 = (part % nq) * BQ;
    float* r = blk.rows + 128 * st;
    wide_load_rows(r, lse + bq * Sq, q0, Sq);
    if (threadIdx.x >= 64 && threadIdx.x < 64 + BQ) {
      const int i = int(threadIdx.x) - 64;
      r[64 + i] = q0 + i < Sq ? dd[bq * Sq + q0 + i] : 0.f;
    }
  }
  __device__ __forceinline__ void partial(int st, bool first) {
    acc.partial(blk.res, blk.stage(st), blk.res + TE, blk.stage(st) + TE, blk.red_s(st), blk.red_dp(st), first);
  }
  __device__ __forceinline__ void exchange(int part, int st) {
    wb_exchange<T, true>(blk.red_s(st), blk.red_dp(st), blk.pushed, blk.rows + 128 * st, blk.rows + 128 * st + 64,
                         blk.steps.pl.nc, blk.steps.rank, mask, scale, (part % nq) * BQ, k0);
  }
  // dV_c += P^T dO_c, dK_c += dS^T Q_c
  __device__ __forceinline__ void output(int st) {
    acc.output(blk.pushed, blk.stage(st) + TE, blk.pushed + B::M::PUSHED / int(sizeof(T)), blk.stage(st));
  }
};

template <typename T, bool VEC, typename Mask>
__global__ void __launch_bounds__(kWbThreads, 1)
    flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dd,
                          T* __restrict__ dk, T* __restrict__ dv, int d, int g, float scale, Mask mask,
                          const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo) {
  extern __shared__ float4 smem4[];
  const int Sq = mask.q_rows(), Sk = mask.k_rows();
  const WidePlan pl = wide_plan(d, kWbC<T, true>);
  const int nk = (Sk + BK - 1) / BK, nq = (Sq + BQ - 1) / BQ, rank = int(blockIdx.x % pl.nc);
  const int64_t cl = blockIdx.x / pl.nc;
  const int pass = int(cl % pl.np), ik = int((cl / pl.np) % nk);
  const int64_t bk = (cl / pl.np) / nk;
  const int k0 = ik * BK;
  WbDkv<T, VEC, Mask> kern{WbBlock<T, true>(wb_smem_base(smem4), pl, rank, pass),
                           WbAcc<T, true>(),
                           q,
                           dout,
                           k + bk * Sk * d,
                           v + bk * Sk * d,
                           &mq,
                           &mk,
                           &mv,
                           &mdo,
                           lse,
                           dd,
                           mask,
                           scale,
                           bk,
                           Sq,
                           Sk,
                           d,
                           g,
                           nq,
                           k0,
                           mask.query_begin(ik),
                           g * nq,
                           mask.fwd_tile_range(k0)};
  if (threadIdx.x == 0) {
    wb_bar_init(kern.blk.bar, kern.TMA ? 1 : kWbThreads);
    wb_bar_init(kern.blk.bar + 1, kern.TMA ? 1 : kWbThreads);
  }
  __syncthreads();
  wb_schedule(kern);
  if (kern.blk.steps.owns())
    kern.acc.template store<VEC>(
        WbOut<T>{dv + bk * Sk * d, dk + bk * Sk * d, k0, Sk, (rank + pl.nc * pass) * kern.C, d});
}

// The launch of a backward kernel: tiles x passes x cluster blocks, in clusters of nc.
template <typename T, bool DKV>
int64_t wide_bwd_blocks(int64_t rows, int n, int d) {
  const WidePlan pl = wide_plan(d, kWbC<T, DKV>);
  return tiles_of(rows, n) * pl.np * pl.nc;
}

// cuTensorMapEncodeTiled, looked up once through the runtime
// (cudaGetDriverEntryPoint, so nothing links libcuda); null where it is missing.
using WbEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
WbEncodeTiled wb_encoder() {
  static WbEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<WbEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A TMA view (d, rows, batch) of a row-major (batch, rows, d) bfloat16
// tensor: boxes of kWbBox columns by 64 rows, zeros past its rows and d.
// 0, or kErrBadShape where it cannot be encoded.
int wb_view(CUtensorMap* map, const void* base, int64_t batch, int rows, int d) {
  const WbEncodeTiled encode = wb_encoder();
  if (encode == nullptr || batch < 1 || rows < 1) return kErrBadShape;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(rows), cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2, cuuint64_t(rows) * d * 2};
  const cuuint32_t box[3] = {cuuint32_t(kWbBox), 64, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : kErrBadShape;
}

// The four views a launch by TMA reads (bfloat16 rows of whole 16-byte
// chunks; q and dO: bhq rows of Sq; k and v: bhk of Sk; no dO view for the
// forward's null dout); left zero otherwise, where the kernel reads none.
template <typename T>
int wb_views(CUtensorMap (&m)[4], bool vec, const void* q, const void* k, const void* v, const void* dout,
             int64_t bhq, int64_t bhk, int sq, int sk, int d) {
  m[0] = m[1] = m[2] = m[3] = CUtensorMap{};
  if (std::is_same_v<T, float> || !vec || bhq == 0 || sq == 0 || sk == 0) return 0;
  int err = wb_view(&m[0], q, bhq, sq, d);
  if (!err) err = wb_view(&m[1], k, bhk, sk, d);
  if (!err) err = wb_view(&m[2], v, bhk, sk, d);
  if (!err && dout != nullptr) err = wb_view(&m[3], dout, bhq, sq, d);
  return err;
}

template <typename T, typename Mask>
int wide_dq_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* dd,
                   void* dq, int64_t bhq, int64_t bhk, int d, float scale, Mask mask, cudaStream_t stream) {
  const bool vec = vec_ok<16 / int(sizeof(T))>(d, q, k, v, dout, dq);
  CUtensorMap m[4];
  const int err = wb_views<T>(m, vec, q, k, v, dout, bhq, bhk, mask.q_rows(), mask.k_rows(), d);
  if (err) return err;
  const auto kern = vec ? flash_wide_dq_kernel<T, true, Mask> : flash_wide_dq_kernel<T, false, Mask>;
  return launch_cluster(kern, WbSmem<T, false>::BYTES, kWbThreads, wide_bwd_blocks<T, false>(bhq, mask.q_rows(), d),
                        wide_plan(d, kWbC<T, false>).nc, bhq, bhk, mask, stream, static_cast<const T*>(q),
                        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd,
                        static_cast<T*>(dq), d, group_of(bhq, bhk), scale, mask, m[0], m[1], m[2], m[3]);
}

template <typename T, typename Mask>
int wide_dkv_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* dd,
                    void* dk, void* dv, int64_t bhq, int64_t bhk, int d, float scale, Mask mask,
                    cudaStream_t stream) {
  const bool vec = vec_ok<16 / int(sizeof(T))>(d, q, k, v, dout, dk, dv);
  CUtensorMap m[4];
  const int err = wb_views<T>(m, vec, q, k, v, dout, bhq, bhk, mask.q_rows(), mask.k_rows(), d);
  if (err) return err;
  const auto kern = vec ? flash_wide_dkv_kernel<T, true, Mask> : flash_wide_dkv_kernel<T, false, Mask>;
  return launch_cluster(kern, WbSmem<T, true>::BYTES, kWbThreads, wide_bwd_blocks<T, true>(bhk, mask.k_rows(), d),
                        wide_plan(d, kWbC<T, true>).nc, bhq, bhk, mask, stream, static_cast<const T*>(q),
                        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd,
                        static_cast<T*>(dk), static_cast<T*>(dv), d, group_of(bhq, bhk), scale, mask, m[0], m[1],
                        m[2], m[3]);
}
