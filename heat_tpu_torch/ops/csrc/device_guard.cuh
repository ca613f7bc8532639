// Makes a device current for one C entry point and gives the caller's
// current device back when the entry point returns, so a call on a tensor
// on another card leaves PyTorch's current device as it found it.
#pragma once

#include <cuda_runtime.h>

namespace heat {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace heat
