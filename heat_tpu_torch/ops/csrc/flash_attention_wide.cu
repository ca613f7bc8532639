// Flash attention at head dims past 256: the wide route of flash_wide.cuh,
// whose note describes it, in a translation unit of its own so that nvcc
// compiles it beside flash_attention.cu and flash_attention_d256.cu.
// flash_attention.cu's C functions forward a d > 256 to these, which take
// the same arguments.  Each is templated on the storage type (float32 on
// the CUDA cores, bfloat16 on the tensor cores) and the mask (StaticMask,
// PosMask); d has no upper cap.

#include "flash_launch.cuh"
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

}  // extern "C"
