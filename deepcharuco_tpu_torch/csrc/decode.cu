// Corner decode: loc/ids logits → fixed-capacity keypoints.
//
// Replaces the Pallas TPU kernel deepcharuco_tpu/ops/pallas_decode.py
// (pallas_pred_to_keypoints, kernel body _decode_kernel), and adds its
// min_margin gate so pred_to_keypoints(min_margin=...) runs here too.
//
// Bound on an H100: memory. At N=256 on a 30×40 grid the f32 logits are
// 256·1200·(65+17)·4 B ≈ 101 MB, about 30 µs at 3.35 TB/s; the arithmetic
// is a few compares per byte. So the design is about bytes in flight.
//
// Design: a work item is a tile of kTile consecutive cells of one image;
// a persistent grid (as many blocks as fit on the card at once, two per SM)
// splits the N·ceil(Hc·Wc / kTile) items into contiguous ranges, one per
// block, so one image is spread over many blocks. A block copies an item's contiguous spans of loc and ids logits
// into shared memory with 16-byte cp.async (scalar loads only for the last
// few floats of the tensor), double-buffered: the next item is in flight
// while the current one is decoded. One thread decodes one cell from shared
// memory (decode_common.cuh); the cell strides of 65 and 17 words are odd,
// so a warp's reads hit 32 distinct banks. Claims go to the block's
// shared-memory key table, then to the image's row of the global key
// scratch when its range moves to the next image, and the block that
// completes an image writes its keypoints (decode_common.cuh). Device
// launches per call: the scratch memset and this kernel.

#include "decode_common.cuh"

namespace {

constexpr int kTile = 128;  // cells per work item, one thread each
constexpr int kThreads = kTile;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// Copy floats [a, b) of g (16-byte aligned, `total` floats long) to dst so
// that dst[(a & 3) + i - a] = g[i]. Whole 16-byte vectors go by cp.async;
// a vector that runs past the end of g is read float by float.
__device__ __forceinline__ void copy_span(float* dst, const float* __restrict__ g,
                                          long long a, long long b, long long total) {
  const long long v0 = a >> 2, v1 = (b + 3) >> 2;
  for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
    float* d = dst + 4 * (v - v0);
    if (4 * v + 4 <= total) {
      cp_async16(d, g + 4 * v);
    } else {
      for (long long e = 4 * v; e < total; ++e) d[e - 4 * v] = g[e];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ loc, const float* __restrict__ ids, int n,
              int m, int wc, int n_ids, int gate, float min_margin,
              unsigned long long* __restrict__ scratch, float* __restrict__ kpts,
              bool* __restrict__ valid) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long table[dc::kMaxIds];
  __shared__ bool last;
  const int ni = n_ids + 1;
  const int loc_floats = (kTile * dc::kLocChannels + 8 + 3) & ~3;
  const int ids_floats = (kTile * ni + 8 + 3) & ~3;
  float* buf[2] = {smem, smem + loc_floats + ids_floats};
  const int tid = threadIdx.x;
  const int tiles = (m + kTile - 1) / kTile;
  const long long items = static_cast<long long>(n) * tiles;
  const long long loc_total = static_cast<long long>(n) * m * dc::kLocChannels;
  const long long ids_total = static_cast<long long>(n) * m * ni;

  if (tid < dc::kMaxIds) table[tid] = 0ull;

  auto fetch = [&](long long w, float* b) {
    const long long img = w / tiles;
    const int c0 = static_cast<int>(w % tiles) * kTile;
    const int c1 = min(m, c0 + kTile);
    const long long g0 = img * m + c0, g1 = img * m + c1;
    copy_span(b, loc, g0 * dc::kLocChannels, g1 * dc::kLocChannels, loc_total);
    copy_span(b + loc_floats, ids, g0 * ni, g1 * ni, ids_total);
  };

  long long w, end;
  dc::item_range(items, blockIdx.x, gridDim.x, w, end);
  if (w < end) fetch(w, buf[0]);
  asm volatile("cp.async.commit_group;\n" ::);
  int done = 0;  // items of the current image in the table
  for (int p = 0; w < end; ++w, p ^= 1) {
    if (w + 1 < end) fetch(w + 1, buf[p ^ 1]);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();  // item w is in buf[p], from every thread's copies

    const long long img = w / tiles;
    const int c0 = static_cast<int>(w % tiles) * kTile;
    const int cell = c0 + tid;
    if (cell < m) {
      const long long g0 = img * m + c0;
      const float* l = buf[p] + ((g0 * dc::kLocChannels) & 3) + tid * dc::kLocChannels;
      const float* d = buf[p] + loc_floats + ((g0 * ni) & 3) + tid * ni;
      int pix;
      float conf;
      int id = dc::decode_cell(l, d, n_ids, gate != 0, min_margin, pix, conf);
      dc::offer(table, id, conf, cell, pix);
    }
    __syncthreads();  // table complete; buf[p] free for the item after next
    ++done;
    if (w + 1 == end || (w + 1) / tiles != img) {  // publish this image's claims
      unsigned long long* row = scratch + img * ni;
      dc::flush(table, row, n_ids, tid);
      __syncthreads();
      if (tid == 0) last = dc::count_items(row, n_ids, done, tiles);
      __syncthreads();
      if (last)
        dc::finish_image(row, n_ids, wc, kpts + img * n_ids * 2, valid + img * n_ids, tid);
      done = 0;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

int smem_bytes(int n_ids) {
  const int loc_floats = (kTile * dc::kLocChannels + 8 + 3) & ~3;
  const int ids_floats = (kTile * (n_ids + 1) + 8 + 3) & ~3;
  return 2 * (loc_floats + ids_floats) * static_cast<int>(sizeof(float));
}

}  // namespace

// loc (n, m, 65) f32, ids (n, m, n_ids+1) f32, both contiguous and 16-byte
// aligned; scratch (n, n_ids+1) uint64, zero; kpts (n, n_ids, 2) f32, valid
// (n, n_ids) bool. Returns cudaGetLastError().
extern "C" int dc_decode(const void* loc, const void* ids, int n, int m, int wc,
                         int n_ids, int gate, float min_margin, void* scratch,
                         void* kpts, void* valid, void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = smem_bytes(n_ids);
  int resident = 0;  // the grid: as many blocks as fit on the card at once
  const cudaError_t err = dc::resident_blocks(decode_kernel, kThreads, smem, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(n) * ((m + kTile - 1) / kTile);
  const int grid = static_cast<int>(items < resident ? items : resident);
  decode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(loc), static_cast<const float*>(ids), n, m, wc, n_ids,
      gate, min_margin, static_cast<unsigned long long*>(scratch),
      static_cast<float*>(kpts), static_cast<bool*>(valid));
  return static_cast<int>(cudaGetLastError());
}
