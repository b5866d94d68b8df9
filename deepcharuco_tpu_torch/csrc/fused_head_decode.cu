// Fused detector heads + corner decode: trunk features → keypoints.
//
// Replaces the Pallas TPU kernel deepcharuco_tpu/ops/pallas_fused.py
// (pallas_fused_head_decode, kernel body _head_decode_kernel). From the
// (N, Hc, Wc, 128) bf16 detector trunk it computes both heads' 3×3 convs
// as one im2col product (cells × 1152) @ (1152 × 512) with BatchNorm folded
// into the weights (fold_head_params), + bias, ReLU, rounds the activations
// to bf16, runs the 1×1 convs to 65 loc and n_ids+1 ids logits (f32
// accumulation + f32 bias), and decodes them (decode_common.cuh). The
// logits never leave the SM; per image only (n_ids, 2) keypoints and
// (n_ids,) valid are written.
//
// Bound on an H100: operations. 2·1200·(1152·512 + 256·65 + 256·17) ≈ 1.47
// GFLOP per image on a 30×40 grid, ≈ 375 GFLOP at N=256, about 0.38 ms at
// 989 TFLOP/s bf16; the 79 MB of trunk are about 23 µs at 3.35 TB/s.
//
// Design (a first, simple version; TMA, wgmma and a pipelined K loop are
// later work): one block of 8 warps per image loops over tiles of 64 cells.
// For each tile and head, the K = 1152 loop streams 64-wide chunks of the
// im2col rows (built on the fly from the trunk, zero padding by bounds
// checks) and of the weights (which stay in L2) through shared memory, and
// each warp runs mma.sync m16n8k16 bf16 on a 32 × 64 slice of the 64 × 256
// head output. The activations go to shared memory as bf16, the 1×1 convs
// run on the same mma shape, and the tile's 64 cells are decoded one warp
// per cell into per-warp winner tables, merged once per image.

#include <cuda_bf16.h>
#include <cstdint>

#include "decode_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileM = 64;   // cells per tile
constexpr int kChunkK = 64;  // K per shared-memory chunk
constexpr int kHead = 256;   // width of each 3×3 head
constexpr int kLocN = 72;    // 65 loc channels padded to 9 mma tiles
constexpr int kIdsN = 32;    // n_ids+1 <= 32 padded to 4 mma tiles
constexpr int kAS = kChunkK + 8;   // row strides (bf16 elements) padded so
constexpr int kActS = kHead + 8;   // fragment loads hit 32 distinct banks

struct Smem {
  __nv_bfloat16 a[kTileM * kAS];      // im2col chunk, row = cell
  __nv_bfloat16 w[kHead * kAS];       // weight chunk, transposed: row = out ch
  __nv_bfloat16 act[kTileM * kActS];  // ReLU output of one head, bf16
  __nv_bfloat16 wpb[kLocN * kActS];   // 1×1 loc weights, transposed
  __nv_bfloat16 wdb[kIdsN * kActS];   // 1×1 ids weights, transposed
  float loc[kTileM * kLocN];
  float ids[kTileM * kIdsN];
  float bpa[kHead], bda[kHead], bpb[kLocN], bdb[kIdsN];
  dc::Winner tables[kWarps * dc::kMaxIds];
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of a row-major 16×16 tile at (row0, k0), row stride s.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* base,
                                       int s, int row0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = base + (row0 + g) * s + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * s);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * s + 8);
}

// B fragment of a 16×8 tile stored n-major (row = output channel) at (n0, k0).
__device__ __forceinline__ void load_b(uint32_t* b, const __nv_bfloat16* base,
                                       int s, int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = base + (n0 + g) * s + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// Copy a (k_rows, n_cols) row-major global matrix into n-major shared rows
// of stride kActS, zero-filling rows n_cols..n_pad-1.
__device__ void load_transposed(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                int k_rows, int n_cols, int n_pad) {
  for (int i = threadIdx.x; i < n_pad * k_rows; i += blockDim.x) {
    int n = i / k_rows, k = i % k_rows;
    dst[n * kActS + k] = n < n_cols ? src[k * n_cols + n] : __float2bfloat16_rn(0.f);
  }
}

// One head's 3×3 conv for one tile: act = bf16(relu(im2col @ w + bias)).
__device__ void head_conv(Smem& sm, const __nv_bfloat16* __restrict__ trunk,
                          const __nv_bfloat16* __restrict__ wh, const float* bias,
                          int head, int img, int tile0, int m, int hc, int wc,
                          int cin) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 × 4 warps over 64 × 256
  const int k_total = 9 * cin;
  float acc[2][8][4] = {};

  for (int k0 = 0; k0 < k_total; k0 += kChunkK) {
    __syncthreads();  // previous chunk (or previous tile's readers) done
    const int tap = k0 / cin, c0 = k0 % cin;
    const int ky = tap / 3 - 1, kx = tap % 3 - 1;
    // im2col chunk: 64 cells × 64 channels, 16-byte vectors
    for (int i = threadIdx.x; i < kTileM * (kChunkK / 8); i += blockDim.x) {
      const int r = i / (kChunkK / 8), v = i % (kChunkK / 8);
      const int cell = tile0 + r;
      const int y = cell / wc + ky, x = cell % wc + kx;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (cell < m && y >= 0 && y < hc && x >= 0 && x < wc)
        val = *reinterpret_cast<const uint4*>(
            trunk + ((static_cast<size_t>(img) * hc + y) * wc + x) * cin + c0 + v * 8);
      *reinterpret_cast<uint4*>(sm.a + r * kAS + v * 8) = val;
    }
    // weight chunk: rows k0..k0+63, this head's 256 columns, transposed
    for (int i = threadIdx.x; i < kChunkK * (kHead / 8); i += blockDim.x) {
      const int kr = i % kChunkK, v = i / kChunkK;
      uint4 val = *reinterpret_cast<const uint4*>(
          wh + static_cast<size_t>(k0 + kr) * (2 * kHead) + head * kHead + v * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) sm.w[(v * 8 + j) * kAS + kr] = e[j];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kChunkK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) load_a(a[mt], sm.a, kAS, wm * 32 + mt * 16, ks, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b[2];
        load_b(b, sm.w, kAS, wn * 64 + nt * 8, ks, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b);
      }
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int row = wm * 32 + mt * 16 + g, col = wn * 64 + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* c = acc[mt][nt] + 2 * half;
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(fmaxf(c[0] + bias[col], 0.f));
        v.y = __float2bfloat16_rn(fmaxf(c[1] + bias[col + 1], 0.f));
        *reinterpret_cast<__nv_bfloat162*>(sm.act + (row + 8 * half) * kActS + col) = v;
      }
    }
  __syncthreads();
}

// out[64 × n_pad] = act @ w1x1 + bias, f32 (n_pad / 8 mma tiles per row tile).
__device__ void head_1x1(Smem& sm, const __nv_bfloat16* w, const float* bias,
                         float* out, int n_pad) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = n_pad / 8;
  for (int tile = warp; tile < (kTileM / 16) * n_tiles; tile += kWarps) {
    const int mt = tile / n_tiles, nt = tile % n_tiles;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int ks = 0; ks < kHead; ks += 16) {
      uint32_t a[4], b[2];
      load_a(a, sm.act, kActS, mt * 16, ks, lane);
      load_b(b, w, kActS, nt * 8, ks, lane);
      mma_bf16(c, a, b);
    }
    const int row = mt * 16 + g, col = nt * 8 + 2 * t;
    out[row * n_pad + col] = c[0] + bias[col];
    out[row * n_pad + col + 1] = c[1] + bias[col + 1];
    out[(row + 8) * n_pad + col] = c[2] + bias[col];
    out[(row + 8) * n_pad + col + 1] = c[3] + bias[col + 1];
  }
}

__global__ void __launch_bounds__(kThreads)
fused_head_decode_kernel(const __nv_bfloat16* __restrict__ trunk,
                         const __nv_bfloat16* __restrict__ wh,
                         const float* __restrict__ bpa, const float* __restrict__ bda,
                         const __nv_bfloat16* __restrict__ wpb,
                         const float* __restrict__ bpb,
                         const __nv_bfloat16* __restrict__ wdb,
                         const float* __restrict__ bdb, int hc, int wc, int cin,
                         int n_ids, int gate, float min_margin,
                         float* __restrict__ kpts, bool* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int img = blockIdx.x, m = hc * wc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_transposed(sm.wpb, wpb, kHead, dc::kLocChannels, kLocN);
  load_transposed(sm.wdb, wdb, kHead, n_ids + 1, kIdsN);
  for (int i = threadIdx.x; i < kHead; i += blockDim.x) {
    sm.bpa[i] = bpa[i];
    sm.bda[i] = bda[i];
  }
  for (int i = threadIdx.x; i < kLocN; i += blockDim.x)
    sm.bpb[i] = i < dc::kLocChannels ? bpb[i] : 0.f;
  for (int i = threadIdx.x; i < kIdsN; i += blockDim.x)
    sm.bdb[i] = i <= n_ids ? bdb[i] : 0.f;
  dc::init_tables(sm.tables, kWarps * dc::kMaxIds);
  // head_conv starts with __syncthreads(), which publishes the above

  for (int tile0 = 0; tile0 < m; tile0 += kTileM) {
    head_conv(sm, trunk, wh, sm.bpa, 0, img, tile0, m, hc, wc, cin);
    head_1x1(sm, sm.wpb, sm.bpb, sm.loc, kLocN);
    head_conv(sm, trunk, wh, sm.bda, 1, img, tile0, m, hc, wc, cin);
    head_1x1(sm, sm.wdb, sm.bdb, sm.ids, kIdsN);
    __syncthreads();
    for (int r = warp; r < kTileM && tile0 + r < m; r += kWarps) {
      dc::Cell c = dc::decode_cell(sm.loc + r * kLocN, sm.ids + r * kIdsN, n_ids,
                                   gate != 0, min_margin, lane);
      if (lane == 0) dc::offer(sm.tables + warp * dc::kMaxIds, c, tile0 + r);
    }
  }
  __syncthreads();
  dc::finalize(sm.tables, kWarps, n_ids, wc, kpts + static_cast<size_t>(img) * n_ids * 2,
               valid + static_cast<size_t>(img) * n_ids);
}

}  // namespace

// trunk (n, hc, wc, cin) bf16 contiguous, cin % 64 == 0; wh (9·cin, 512)
// bf16; bpa/bda (256) f32; wpb (256, 65) bf16; bpb (65) f32; wdb (256,
// n_ids+1) bf16; bdb (n_ids+1) f32. kpts (n, n_ids, 2) f32, valid (n, n_ids)
// bool. Returns cudaGetLastError().
extern "C" int dc_fused_head_decode(const void* trunk, const void* wh,
                                    const void* bpa, const void* bda,
                                    const void* wpb, const void* bpb,
                                    const void* wdb, const void* bdb, int n,
                                    int hc, int wc, int cin, int n_ids, int gate,
                                    float min_margin, void* kpts, void* valid,
                                    void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      fused_head_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0)
    fused_head_decode_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(trunk), static_cast<const __nv_bfloat16*>(wh),
        static_cast<const float*>(bpa), static_cast<const float*>(bda),
        static_cast<const __nv_bfloat16*>(wpb), static_cast<const float*>(bpb),
        static_cast<const __nv_bfloat16*>(wdb), static_cast<const float*>(bdb), hc, wc,
        cin, n_ids, gate, min_margin, static_cast<float*>(kpts),
        static_cast<bool*>(valid));
  return static_cast<int>(cudaGetLastError());
}
