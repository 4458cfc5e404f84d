// Launch-time runtime calls, made once.
//
// A kernel's function attributes (its dynamic shared memory, a
// non-portable cluster size) and the device limits and occupancy a
// launch plan reads are set or read on the first call for each kernel,
// value and device, and remembered.  That first call is eager (a serving
// program's warm run, `runtime/programs.py`), so a later call made while
// a CUDA graph is being captured issues none of these calls.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace dl4j {

struct AttrSet {
  const void* fn;
  int attr;
  int dev;
  int value;
};

struct DevAttr {
  int attr;
  int dev;
  int value;
};

struct Occupancy {
  const void* fn;
  int threads;
  size_t smem;
  int dev;
  int blocks;
};

inline std::mutex& launch_once_mutex() {
  static std::mutex m;
  return m;
}

// `attr` of kernel `fn` on the current device raised to at least `value`
// (the largest value asked so far stays set: both attributes set here are
// upper limits, so a larger one never hurts a smaller launch).
inline cudaError_t set_attribute_once(const void* fn, cudaFuncAttribute attr,
                                      int value) {
  static std::vector<AttrSet> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(launch_once_mutex());
  for (AttrSet& a : done) {
    if (a.fn == fn && a.attr == (int)attr && a.dev == dev) {
      if (a.value >= value) return cudaSuccess;
      err = cudaFuncSetAttribute(fn, attr, value);
      if (err == cudaSuccess) a.value = value;
      return err;
    }
  }
  err = cudaFuncSetAttribute(fn, attr, value);
  if (err == cudaSuccess) done.push_back({fn, (int)attr, dev, value});
  return err;
}

// The current device's `attr`, read once.
inline cudaError_t device_attribute_once(cudaDeviceAttr attr, int* value) {
  static std::vector<DevAttr> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(launch_once_mutex());
  for (const DevAttr& a : done) {
    if (a.attr == (int)attr && a.dev == dev) {
      *value = a.value;
      return cudaSuccess;
    }
  }
  err = cudaDeviceGetAttribute(value, attr, dev);
  if (err == cudaSuccess) done.push_back({(int)attr, dev, *value});
  return err;
}

// Blocks of `fn` an SM holds at `threads` a block and `smem` bytes of
// dynamic shared memory on the current device, read once.
inline cudaError_t max_active_blocks_once(int* blocks, const void* fn,
                                          int threads, size_t smem) {
  static std::vector<Occupancy> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(launch_once_mutex());
  for (const Occupancy& o : done) {
    if (o.fn == fn && o.threads == threads && o.smem == smem &&
        o.dev == dev) {
      *blocks = o.blocks;
      return cudaSuccess;
    }
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                      smem);
  if (err == cudaSuccess) done.push_back({fn, threads, smem, dev, *blocks});
  return err;
}

}  // namespace dl4j
