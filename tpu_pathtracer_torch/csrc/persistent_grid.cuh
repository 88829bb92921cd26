// The grid of a persistent kernel: as many blocks as the current device's
// SMs hold at once.
//
// Counted at the first launch of each (kernel, device, shared-memory size)
// and kept, so later launches, and launches captured in a CUDA graph, make
// no runtime query.  The kernel's dynamic shared-memory limit (past the
// 48 KB a block gets without asking, for the larger rings) is set on each
// device and only ever raised, so a graph captured at a larger size stays
// launchable after a smaller one runs.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

struct GridEntry {
  const void* kernel;
  int device;
  size_t smem;  // the shared-memory size of the grid, or the limit set
  int grid;
};

constexpr int kGridEntries = 64;

// The entry of (kernel, device[, smem]) in table[0, n), or nullptr.
GridEntry* find_entry(GridEntry* table, int n, const void* kernel, int device, size_t smem,
                      bool any_smem) {
  for (int i = 0; i < n; ++i)
    if (table[i].kernel == kernel && table[i].device == device &&
        (any_smem || table[i].smem == smem))
      return &table[i];
  return nullptr;
}

cudaError_t persistent_grid(const void* kernel, int threads, size_t smem, int* grid) {
  static std::mutex lock;
  static GridEntry grids[kGridEntries], limits[kGridEntries];
  static int n_grids = 0, n_limits = 0;
  std::lock_guard<std::mutex> hold(lock);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (const GridEntry* e = find_entry(grids, n_grids, kernel, device, smem, false)) {
    *grid = e->grid;
    return cudaSuccess;
  }
  GridEntry* limit = find_entry(limits, n_limits, kernel, device, 0, true);
  if (limit == nullptr || limit->smem < smem) {
    if (limit == nullptr && n_limits == kGridEntries) return cudaErrorMemoryAllocation;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return err;
    if (limit == nullptr) limit = &limits[n_limits++];
    *limit = GridEntry{kernel, device, smem, 0};
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  if (n_grids < kGridEntries) grids[n_grids++] = GridEntry{kernel, device, smem, *grid};
  return cudaSuccess;
}

}  // namespace
