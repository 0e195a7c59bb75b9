// Host-side state that the launchers keep once a CUDA device.
//
// A launcher asks the device once for what does not change (its SM count,
// a kernel's resident blocks) and raises a kernel's dynamic shared-memory
// limit once, which CUDA keeps per device. Several host threads, each
// driving its own card, call the same entry points at once, so that state
// is one slot a device ordinal, never one value for whichever device asked
// last. A slot is an atomic written once its value is known: two threads
// that race on one device's slot compute the same value, and the later
// store changes nothing.
#pragma once

#include <atomic>
#include <cuda_runtime.h>

namespace device_state {

constexpr int MAX_DEVICES = 64;  // an ordinal at or past this is asked again at every call

// One int a device, 0 until set; every value kept here is positive.
struct PerDevice {
  std::atomic<int> slot[MAX_DEVICES] = {};

  int get(int dev) const {
    return dev >= 0 && dev < MAX_DEVICES ? slot[dev].load(std::memory_order_acquire) : 0;
  }
  void set(int dev, int value) {
    if (dev >= 0 && dev < MAX_DEVICES) slot[dev].store(value, std::memory_order_release);
  }
};

// Raises the kernel's dynamic shared-memory limit on the current device,
// once a device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, PerDevice& configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || configured.get(dev)) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) configured.set(dev, 1);
  return e;
}

// SMs of the current device, asked once a device; 0 on an error.
inline int sm_count() {
  static PerDevice sms;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int n = sms.get(dev);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    sms.set(dev, n);
  }
  return n;
}

}  // namespace device_state
