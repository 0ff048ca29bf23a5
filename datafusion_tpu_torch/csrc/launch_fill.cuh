// How many blocks of a kernel fill the card at a given dynamic shared
// memory size: the occupancy per SM times the SMs, with the kernel's
// shared-memory limit raised first where the size needs it.
//
// The answer is kept per (device, kernel, smem): the attribute call and
// the occupancy query cost host time that a call of a sub-millisecond
// kernel would pay every time. The limit is set on a kernel's first launch
// on a device and for every larger size after it, and never lowered: a
// launch with less than the largest size seen still fits, and a lowered
// limit would refuse a later, larger launch. It is set below 48 KB too,
// since a kernel's static shared memory counts against the default.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

template <typename K>
static inline long long dft_fill_blocks(K kernel, int threads, int smem, cudaError_t* err) {
  struct Known { int dev; const void* kernel; int smem; long long blocks; };
  static std::vector<Known> known;  // grows: every card times every kernel and size
  static std::mutex mu;
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  int limit = -1;  // the limit set for this kernel on this device so far
  for (const Known& k : known) {
    if (k.dev != dev || k.kernel != (const void*)kernel) continue;
    if (k.smem == smem) return k.blocks;
    if (k.smem > limit) limit = k.smem;
  }
  if (smem > limit) *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (*err != cudaSuccess) return 0;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (*err == cudaSuccess && per_sm < 1) *err = cudaErrorInvalidConfiguration;
  if (*err != cudaSuccess) return 0;
  const long long blocks = (long long)per_sm * sms;
  known.push_back({dev, (const void*)kernel, smem, blocks});
  return blocks;
}
