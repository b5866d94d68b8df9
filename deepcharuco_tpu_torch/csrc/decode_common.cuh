// Corner decode shared by the decode kernel (decode.cu) and the fused
// head + decode kernel (fused_head_decode.cu), so the two cannot drift apart.
//
// Per cell: the first-max argmax over the 65 loc channels (pix), the
// first-max argmax and the max over the n_ids+1 ids channels (id, conf),
// dustbin suppression (pix 64 or id n_ids) and the optional min_margin gate
// (conf minus the ids dustbin logit). merge() is the first-max step that
// both kernels build their argmaxes from, claim() the rest.
//
// The per-id winner across cells — the highest confidence, equal
// confidences to the lowest row-major cell — is a reduction over a whole
// image that runs across many blocks. Every claim becomes one totally
// ordered 64-bit key,
//
//   bits 63..32  ordered(conf)        monotone map of the float's bits
//   bits 31..8   2^24 - 1 - cell      so the lower cell is the larger key
//   bits  7..0   pix                  decided by the cell; never breaks a tie
//
// and the winner is the maximum key. −0.0 is mapped to +0.0 first, so a
// +0.0/−0.0 tie goes to the lower cell as jnp.argmax's does. Key 0 means
// "no claim" (ordered() of a non-NaN float is never 0). A block reduces its
// claims with shared-memory atomicMax into a table of n_ids keys, then
// merges the table into an (N, n_ids + 1) uint64 scratch (zeroed by the
// wrapper) with one global atomicMax per (image, id); column n_ids counts
// the work items of the image that are done. Each block walks a contiguous
// range of work items and publishes its table only when the image changes,
// so an image costs a block one merge, not one per item. The block that
// completes an image's count writes its keypoints (finish_image). The order
// is total, so the result does not depend on the order of the atomics.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <mutex>

namespace dc {

constexpr int kMaxDevices = 64;
constexpr int kLocChannels = 65;
constexpr int kLocDustbin = 64;
constexpr int kMaxIds = 32;  // n_ids + 1 <= 32
constexpr int kCellBits = 24;
constexpr int kMaxCells = 1 << kCellBits;  // the wrapper refuses Hc·Wc >= this
constexpr int kTensorMapError = -1;         // a host entry point's own status

// One step of a first-max argmax: (v, i) takes (v2, i2) if v2 is larger, or
// equal with a lower index.
__device__ __forceinline__ void merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// The claimed id of a decoded cell, or -1.
__device__ __forceinline__ int claim(int pix, int id, float conf, float dust,
                                     int n_ids, bool gate, float min_margin) {
  if (pix == kLocDustbin || id == n_ids) return -1;
  if (gate && !(conf - dust >= min_margin)) return -1;
  return id;
}

__device__ __forceinline__ uint32_t ordered(float f) {
  uint32_t u = __float_as_uint(f == 0.f ? 0.f : f);  // −0.0 → +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long key_of(float conf, int cell, int pix) {
  return (static_cast<unsigned long long>(ordered(conf)) << 32) |
         (static_cast<unsigned long long>(kMaxCells - 1 - cell) << 8) |
         static_cast<unsigned long long>(pix);
}

// One thread decodes one cell whose logits lie at loc[0..64] and
// ids[0..n_ids] (shared or global memory). Returns the claimed id or -1;
// pix and conf are written when it claims.
__device__ __forceinline__ int decode_cell(const float* loc, const float* ids,
                                           int n_ids, bool gate, float min_margin,
                                           int& pix, float& conf) {
  float lv = loc[0];
  int li = 0;
#pragma unroll 13
  for (int c = 1; c < kLocChannels; ++c) merge(lv, li, loc[c], c);
  float iv = ids[0];
  int ii = 0;
  for (int c = 1; c <= n_ids; ++c) merge(iv, ii, ids[c], c);
  pix = li;
  conf = iv;
  return claim(li, ii, iv, ids[n_ids], n_ids, gate, min_margin);
}

// Block-level table of the best key per id, in shared memory.
__device__ __forceinline__ void offer(unsigned long long* table, int id, float conf,
                                      int cell, int pix) {
  if (id >= 0) atomicMax(table + id, key_of(conf, cell, pix));
}

// Threads 0..n_ids-1: merge the block's table into the image's scratch row
// and clear the table for the next image. Every thread that merged has
// fenced before it returns, so a later count of the items is ordered after
// their keys.
__device__ __forceinline__ void flush(unsigned long long* table,
                                      unsigned long long* scratch_row, int n_ids,
                                      int tid) {
  if (tid < n_ids) {
    unsigned long long k = table[tid];
    if (k) atomicMax(scratch_row + tid, k);
    table[tid] = 0ull;
    __threadfence();
  }
}

// The range of work items of block b out of g: contiguous, sizes within one.
__device__ __forceinline__ void item_range(long long items, int b, int g,
                                           long long& begin, long long& end) {
  begin = items * b / g;
  end = items * (b + 1) / g;
}

// One thread: count `done` finished work items of an image of `items`; true
// for the block whose count completes it (it then writes the keypoints).
__device__ __forceinline__ bool count_items(unsigned long long* scratch_row, int n_ids,
                                            unsigned long long done,
                                            unsigned long long items) {
  return atomicAdd(scratch_row + n_ids, done) + done == items;
}

// Threads 0..n_ids-1 of the block that completed the image: keys → one
// image's keypoints (n_ids, 2) and valid (n_ids). Unclaimed slots are (0, 0).
__device__ __forceinline__ void finish_image(const unsigned long long* scratch_row,
                                             int n_ids, int wc, float* kpts, bool* valid,
                                             int tid) {
  if (tid >= n_ids) return;
  __threadfence();
  unsigned long long k =
      *reinterpret_cast<const volatile unsigned long long*>(scratch_row + tid);
  float x = 0.f, y = 0.f;
  if (k) {
    int cell = kMaxCells - 1 - static_cast<int>((k >> 8) & (kMaxCells - 1));
    int pix = static_cast<int>(k & 0xff);
    x = static_cast<float>(8 * (cell % wc) + pix % 8);
    y = static_cast<float>(8 * (cell / wc) + pix / 8);
  }
  kpts[2 * tid] = x;
  kpts[2 * tid + 1] = y;
  valid[tid] = k != 0ull;
}

// Host: lets `kernel` take `smem` bytes of dynamic shared memory on the
// current device and gives the number of its blocks (of `threads` threads)
// that fit on that device at once. Worked out once per (device, smem) and
// kept per device, since the host cost of a call matters at N=1. Safe to
// call from several host threads. Internal linkage, so that each library
// keeps its own cache and calls its own CUDA runtime: an instantiation
// with external linkage would be merged across the loaded libraries.
template <typename Kernel>
static cudaError_t resident_blocks(Kernel kernel, int threads, int smem, int& blocks) {
  struct Entry {
    int smem = -1, blocks = 0;
  };
  static std::mutex mu;
  static Entry cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  Entry& e = cache[dev];
  if (e.smem != smem) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    e.smem = smem;
    e.blocks = sms * per_sm;
  }
  blocks = e.blocks;
  return cudaSuccess;
}

}  // namespace dc

extern "C" const char* dc_error_string(int status) {
  if (status == dc::kTensorMapError) return "a TMA tensor map could not be encoded";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
