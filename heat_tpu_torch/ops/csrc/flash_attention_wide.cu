// Flash attention at head dims past 256: the wide route, the forward of
// flash_wide.cuh and the backward of flash_wide_bwd.cuh (all three in
// thread block clusters), whose notes describe them, in a translation unit of
// its own so that nvcc compiles it beside flash_attention.cu and
// flash_attention_d256.cu.  flash_attention.cu's C functions forward a
// d > 256 to these, which take the same arguments.  Each is templated on
// the storage type (float32 on the CUDA cores, bfloat16 on the tensor
// cores) and the mask (StaticMask, PosMask); d has no upper cap.

#include <cuda.h>  // CUtensorMap: the TMA views (encoded by cuTensorMapEncodeTiled)

#include "flash_launch.cuh"
#include "flash_wide_bwd.cuh"
#include "flash_wide.cuh"

#define HEAT_FLASH_WIDE(BF16, CALL)     \
  do {                                  \
    if (BF16) {                         \
      using T = __nv_bfloat16;          \
      CALL;                             \
    } else {                            \
      using T = float;                  \
      CALL;                             \
    }                                   \
  } while (0)

constexpr int kPlanDq = 0, kPlanDkv = 1, kPlanFwd = 2;  // heat_flash_wide_plan's kernels

template <typename T>
void wide_plan_of(int d, int kernel, int* out) {
  const int C = kernel == kPlanDkv ? kWbC<T, true> : kWbC<T, false>;
  const WidePlan pl = wide_plan(d, C);
  out[0] = pl.nc;
  out[1] = C;
  out[2] = pl.np;
  out[3] = kernel == kPlanFwd ? WfSmem<T>::BYTES : kernel == kPlanDkv ? WbSmem<T, true>::BYTES : WbSmem<T, false>::BYTES;
  out[4] = kernel == kPlanFwd ? pl.np + 1 : 2 * pl.np + (kernel == kPlanDkv ? 2 : 1);
}

}  // namespace

extern "C" {

int heat_flash_fwd_wide(int device, const void* q, const void* k, const void* v, void* out, float* lse, int64_t bhq,
                        int64_t bhk, int s, int d, int bf16, float scale, int causal, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_WIDE(bf16, return (wide_fwd_launch<T>(q, k, v, out, lse, bhq, bhk, d, scale, StaticMask{s, causal},
                                                    static_cast<cudaStream_t>(stream))));
}

int heat_flash_bwd_dq_wide(int device, const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dd, void* dq, int64_t bhq, int64_t bhk, int s, int d,
                           int bf16, float scale, int causal, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_WIDE(bf16, return (wide_dq_launch<T>(q, k, v, dout, lse, dd, dq, bhq, bhk, d, scale,
                                                   StaticMask{s, causal}, static_cast<cudaStream_t>(stream))));
}

int heat_flash_bwd_dkv_wide(int device, const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dd, void* dk, void* dv, int64_t bhq, int64_t bhk, int s,
                            int d, int bf16, float scale, int causal, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_WIDE(bf16, return (wide_dkv_launch<T>(q, k, v, dout, lse, dd, dk, dv, bhq, bhk, d, scale,
                                                    StaticMask{s, causal}, static_cast<cudaStream_t>(stream))));
}

int heat_flash_pos_fwd_wide(int device, const void* q, const void* k, const void* v, const int* qpos,
                            const int* kpos, void* out, float* lse, int64_t b, int sq, int sk, int d, int bf16,
                            float scale, int causal, int s_valid, int masked, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  const PosMask mask{qpos, kpos, sq, sk, s_valid, causal, masked};
  HEAT_FLASH_WIDE(bf16, return (wide_fwd_launch<T>(q, k, v, out, lse, b, b, d, scale, mask,
                                                    static_cast<cudaStream_t>(stream))));
}

int heat_flash_pos_bwd_dq_wide(int device, const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* dd, const int* qpos, const int* kpos, void* dq,
                               int64_t b, int sq, int sk, int d, int bf16, float scale, int causal, int s_valid,
                               int masked, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  const PosMask mask{qpos, kpos, sq, sk, s_valid, causal, masked};
  HEAT_FLASH_WIDE(bf16, return (wide_dq_launch<T>(q, k, v, dout, lse, dd, dq, b, b, d, scale, mask,
                                                   static_cast<cudaStream_t>(stream))));
}

int heat_flash_pos_bwd_dkv_wide(int device, const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* dd, const int* qpos, const int* kpos, void* dk,
                                void* dv, int64_t b, int sq, int sk, int d, int bf16, float scale, int causal,
                                int s_valid, int masked, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  const PosMask mask{qpos, kpos, sq, sk, s_valid, causal, masked};
  HEAT_FLASH_WIDE(bf16, return (wide_dkv_launch<T>(q, k, v, dout, lse, dd, dk, dv, b, b, d, scale, mask,
                                                    static_cast<cudaStream_t>(stream))));
}

// The wide route's split of head dim d for ``kernel`` (0 dq, 1 dk/dv, 2 the
// forward; bf16: bfloat16, else float32): out[0] blocks a cluster, out[1]
// columns a block, out[2] passes, out[3] shared bytes a block, out[4]
// products at full d that the plan gives a live tile pair (the bound's are
// 2 for the forward, 3 for dq, 4 for dk/dv), counted from the split, not by
// the kernels.  0, or kErrUnsupportedD for d < 1 or another kernel.
int heat_flash_wide_plan(int d, int bf16, int kernel, int* out) {
  if (d < 1 || kernel < kPlanDq || kernel > kPlanFwd) return kErrUnsupportedD;
  if (bf16)
    wide_plan_of<__nv_bfloat16>(d, kernel, out);
  else
    wide_plan_of<float>(d, kernel, out);
  return 0;
}

#ifdef HEAT_WB_PHASES
// The wide kernels' phase cycles since the last call (wb_phase_cycles,
// kPhKinds x (kPhPairs + 1) counters: dq, dk/dv, then the forward), then
// zeroed; 0 or a CUDA error.
int heat_wb_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, wb_phase_cycles, sizeof(wb_phase_cycles));
  if (err != cudaSuccess) return int(err);
  unsigned long long zero[kPhKinds][kPhPairs + 1] = {};
  return int(cudaMemcpyToSymbol(wb_phase_cycles, zero, sizeof(zero)));
}
#endif

}  // extern "C"
