// Corner decode shared by the decode kernel (decode.cu) and the fused
// head + decode kernel (fused_head_decode.cu).
//
// One warp decodes one cell: the first-max argmax over the 65 loc channels,
// the first-max argmax and the max over the n_ids+1 ids channels, dustbin
// suppression (loc argmax 64 or ids argmax n_ids) and the optional
// min_margin gate (winning id logit minus the ids dustbin logit).
//
// The per-id winner across cells: every warp keeps its own table of the
// best claiming cell per id in shared memory (only lane 0 writes it, so no
// atomics), and after the cell loop one thread per id merges the warps'
// tables. The winner is the highest confidence; equal confidences go to the
// lowest row-major cell. A slot that no cell claims is written as (0, 0),
// valid = false.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace dc {

constexpr int kLocChannels = 65;
constexpr int kLocDustbin = 64;
constexpr int kMaxIds = 32;  // n_ids + 1 <= 32: one ids channel per lane

struct Cell {
  int pix;     // loc argmax, 0..64
  int id;      // claimed corner id, or -1
  float conf;  // max ids logit
};

struct Winner {
  float conf;
  int cell;  // -1: no claim yet
  int pix;
};

__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Butterfly reduction: every lane ends with the warp's (max, first index).
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    argmax_merge(v, i, v2, i2);
  }
}

// Called by all 32 lanes of a warp; every lane gets the result.
// `loc` points at the cell's 65 loc logits, `ids` at its n_ids+1 ids logits
// (global or shared memory).
__device__ __forceinline__ Cell decode_cell(const float* loc, const float* ids,
                                            int n_ids, bool gate,
                                            float min_margin, int lane) {
  float lv = -CUDART_INF_F;
  int li = INT_MAX;
  for (int c = lane; c < kLocChannels; c += 32) argmax_merge(lv, li, loc[c], c);
  warp_argmax(lv, li);

  float iv = -CUDART_INF_F;
  int ii = INT_MAX;
  if (lane <= n_ids) {
    iv = ids[lane];
    ii = lane;
  }
  warp_argmax(iv, ii);

  int id = (li == kLocDustbin || ii == n_ids) ? -1 : ii;
  if (gate && id >= 0) {
    float dust = ids[n_ids];
    if (!(iv - dust >= min_margin)) id = -1;
  }
  return Cell{li, id, iv};
}

__device__ __forceinline__ bool beats(float conf, int cell, const Winner& w) {
  return w.cell < 0 || conf > w.conf || (conf == w.conf && cell < w.cell);
}

// Lane 0 only: offer a decoded cell to this warp's table.
__device__ __forceinline__ void offer(Winner* table, const Cell& c, int cell) {
  if (c.id < 0) return;
  Winner& w = table[c.id];
  if (beats(c.conf, cell, w)) w = Winner{c.conf, cell, c.pix};
}

__device__ __forceinline__ void init_tables(Winner* tables, int n_entries) {
  for (int i = threadIdx.x; i < n_entries; i += blockDim.x)
    tables[i] = Winner{0.f, -1, 0};
}

// Threads 0..n_ids-1 merge the n_warps tables (stride kMaxIds) and write
// one image's keypoints (n_ids, 2) and valid (n_ids).
__device__ __forceinline__ void finalize(const Winner* tables, int n_warps,
                                         int n_ids, int wc, float* kpts,
                                         bool* valid) {
  int k = threadIdx.x;
  if (k >= n_ids) return;
  Winner best{0.f, -1, 0};
  for (int w = 0; w < n_warps; ++w) {
    Winner t = tables[w * kMaxIds + k];
    if (t.cell >= 0 && beats(t.conf, t.cell, best)) best = t;
  }
  float x = 0.f, y = 0.f;
  if (best.cell >= 0) {
    x = static_cast<float>(8 * (best.cell % wc) + best.pix % 8);
    y = static_cast<float>(8 * (best.cell / wc) + best.pix / 8);
  }
  kpts[2 * k] = x;
  kpts[2 * k + 1] = y;
  valid[k] = best.cell >= 0;
}

}  // namespace dc

extern "C" const char* dc_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
