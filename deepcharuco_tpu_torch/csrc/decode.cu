// Corner decode: loc/ids logits → fixed-capacity keypoints.
//
// Replaces the Pallas TPU kernel deepcharuco_tpu/ops/pallas_decode.py
// (pallas_pred_to_keypoints, kernel body _decode_kernel), and adds its
// min_margin gate so pred_to_keypoints(min_margin=...) runs here too.
//
// Bound on an H100: memory. At N=256 on a 30×40 grid the f32 logits are
// 256·1200·(65+17)·4 B ≈ 101 MB, about 30 µs at 3.35 TB/s; the arithmetic
// is a few compares per byte.
//
// Design: the TPU ran one sequential grid step per image; here one block
// per image loops over its cells, one warp per cell, so each cell's 65 loc
// and 17 ids logits are read by adjacent lanes (coalesced). The per-id
// winner across cells lives in per-warp tables in shared memory and is
// merged once per image (decode_common.cuh): no atomics, no second pass.
// 256 images fill the 132 SMs with all blocks resident at once.

#include "decode_common.cuh"

namespace {

constexpr int kWarps = 16;

__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const float* __restrict__ loc, const float* __restrict__ ids,
              int m, int wc, int n_ids, int gate, float min_margin,
              float* __restrict__ kpts, bool* __restrict__ valid) {
  __shared__ dc::Winner tables[kWarps * dc::kMaxIds];
  dc::init_tables(tables, kWarps * dc::kMaxIds);
  __syncthreads();

  const int img = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* L = loc + static_cast<size_t>(img) * m * dc::kLocChannels;
  const float* I = ids + static_cast<size_t>(img) * m * (n_ids + 1);
  for (int cell = warp; cell < m; cell += kWarps) {
    dc::Cell c = dc::decode_cell(L + static_cast<size_t>(cell) * dc::kLocChannels,
                                 I + static_cast<size_t>(cell) * (n_ids + 1),
                                 n_ids, gate != 0, min_margin, lane);
    if (lane == 0) dc::offer(tables + warp * dc::kMaxIds, c, cell);
  }
  __syncthreads();
  dc::finalize(tables, kWarps, n_ids, wc, kpts + static_cast<size_t>(img) * n_ids * 2,
               valid + static_cast<size_t>(img) * n_ids);
}

}  // namespace

// loc (n, m, 65) f32, ids (n, m, n_ids+1) f32, both contiguous;
// kpts (n, n_ids, 2) f32, valid (n, n_ids) bool. Returns cudaGetLastError().
extern "C" int dc_decode(const void* loc, const void* ids, int n, int m, int wc,
                         int n_ids, int gate, float min_margin, void* kpts,
                         void* valid, void* stream) {
  if (n > 0)
    decode_kernel<<<n, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(loc), static_cast<const float*>(ids), m, wc,
        n_ids, gate, min_margin, static_cast<float*>(kpts),
        static_cast<bool*>(valid));
  return static_cast<int>(cudaGetLastError());
}
