// Flash attention at head dims 129 to 256 (D = 256): the same kernels as
// flash_attention.cu, whose note describes them, built in a translation unit
// of their own so that nvcc compiles both files at once.  flash_attention.cu's
// C functions forward a d in (128, 256] to these, which take the same
// arguments.  At D = 256 the float32 rings keep one stage and dq takes
// 32-row blocks (flash_f32.cuh), the bfloat16 forward and dq read their Q
// and dO fragments from shared memory and dk/dv runs two passes
// (flash_fwd_tc.cuh, flash_bwd_tc.cuh): every body fits 227 KB of shared
// memory and 255 registers a thread.

#include "flash_launch.cuh"

#define HEAT_FLASH_DISPATCH(BF16, DIM, CALL)                                      \
  do {                                                                            \
    if ((DIM) < 1 || (DIM) > 256) return kErrUnsupportedD;                       \
    if (BF16) {                                                                   \
      using T = __nv_bfloat16;                                                    \
      constexpr int D = 256;                                                      \
      CALL;                                                                       \
    } else {                                                                      \
      using T = float;                                                            \
      constexpr int D = 256;                                                      \
      CALL;                                                                       \
    }                                                                             \
  } while (0)

}  // namespace

extern "C" {

int heat_flash_fwd_d256(int device, const void* q, const void* k, const void* v, void* out, float* lse, int64_t bhq,
                   int64_t bhk, int s, int d, int bf16, float scale, int causal, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_DISPATCH(bf16, d, return (fwd_launch<T, D>(q, k, v, out, lse, bhq, bhk, d, scale, StaticMask{s, causal},
                                                        static_cast<cudaStream_t>(stream))));
}

int heat_flash_bwd_dq_d256(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* dd, void* dq, int64_t bhq, int64_t bhk, int s, int d, int bf16, float scale,
                      int causal, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_DISPATCH(bf16, d, return (dq_launch<T, D>(q, k, v, dout, lse, dd, dq, bhq, bhk, d, scale,
                                                       StaticMask{s, causal}, static_cast<cudaStream_t>(stream))));
}

int heat_flash_bwd_dkv_d256(int device, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* dd, void* dk, void* dv, int64_t bhq, int64_t bhk, int s, int d, int bf16,
                       float scale, int causal, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  HEAT_FLASH_DISPATCH(bf16, d, return (dkv_launch<T, D>(q, k, v, dout, lse, dd, dk, dv, bhq, bhk, d, scale,
                                                        StaticMask{s, causal}, static_cast<cudaStream_t>(stream))));
}

int heat_flash_pos_fwd_d256(int device, const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                       void* out, float* lse, int64_t b, int sq, int sk, int d, int bf16, float scale, int causal,
                       int s_valid, int masked, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  const PosMask mask{qpos, kpos, sq, sk, s_valid, causal, masked};
  HEAT_FLASH_DISPATCH(bf16, d, return (fwd_launch<T, D>(q, k, v, out, lse, b, b, d, scale, mask,
                                                        static_cast<cudaStream_t>(stream))));
}

int heat_flash_pos_bwd_dq_d256(int device, const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* dd, const int* qpos, const int* kpos, void* dq, int64_t b,
                          int sq, int sk, int d, int bf16, float scale, int causal, int s_valid, int masked,
                          void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  const PosMask mask{qpos, kpos, sq, sk, s_valid, causal, masked};
  HEAT_FLASH_DISPATCH(bf16, d, return (dq_launch<T, D>(q, k, v, dout, lse, dd, dq, b, b, d, scale, mask,
                                                       static_cast<cudaStream_t>(stream))));
}

int heat_flash_pos_bwd_dkv_d256(int device, const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dd, const int* qpos, const int* kpos, void* dk, void* dv,
                           int64_t b, int sq, int sk, int d, int bf16, float scale, int causal, int s_valid,
                           int masked, void* stream) {
  const heat::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return int(guard.error());
  const PosMask mask{qpos, kpos, sq, sk, s_valid, causal, masked};
  HEAT_FLASH_DISPATCH(bf16, d, return (dkv_launch<T, D>(q, k, v, dout, lse, dd, dk, dv, b, b, d, scale, mask,
                                                        static_cast<cudaStream_t>(stream))));
}

}  // extern "C"
