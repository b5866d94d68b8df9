// Fused detector heads + corner decode: trunk features → keypoints.
//
// Replaces the Pallas TPU kernel deepcharuco_tpu/ops/pallas_fused.py
// (pallas_fused_head_decode, kernel body _head_decode_kernel). From the
// (N, Hc, Wc, 128) bf16 detector trunk it computes both heads' 3×3 convs
// as one im2col product (cells × 1152) @ (1152 × 512) with BatchNorm folded
// into the weights (fold_head_params), + bias, ReLU, rounds the activations
// to bf16, runs the 1×1 convs to 65 loc and n_ids+1 ids logits (f32
// accumulation + f32 bias), and decodes them (decode_common.cuh). The
// activations and logits never leave the SM; per image only (n_ids, 2)
// keypoints and (n_ids,) valid are written.
//
// Bound on an H100: operations. 2·1200·(1152·512 + 256·65 + 256·17) ≈ 1.47
// GFLOP per image on a 30×40 grid, ≈ 375 GFLOP at N=256, about 0.38 ms at
// 989 TFLOP/s bf16; the 79 MB of trunk are about 23 µs at 3.35 TB/s.
//
// Design. A work item is a tile of 16 × 8 cells of one image; a persistent
// grid of one block per SM splits the N·ceil(Hc/16)·ceil(Wc/8) items into
// contiguous ranges, so every image is spread over many blocks (10 on a
// 30×40 grid, also at N=1). A block has three warpgroups:
//
// - a producer warp (warpgroup 2, registers given up with setmaxnreg) that
//   keeps a 4-stage ring of shared-memory tiles full with TMA
//   (cp.async.bulk.tensor) and mbarriers. One stage is one 64-deep slice of
//   K = 9 taps × 128 channels for one head: the A tile is a 4-D TMA box
//   (64 channels × 8 × 16 cells) of the trunk at the tap's offset, so the
//   hardware does the im2col gather and fills the 3×3 conv's zero padding
//   for out-of-range (also negative) coordinates; the B tile is the head's
//   slice of the packed weights whT = wh.T (512 × 1152, packed once on the
//   host by pack_head_params), which lands K-major in the
//   128-byte-swizzled layout wgmma reads. Nothing is transposed in the
//   kernel. After a head's 18 slices one stage brings its packed 1×1
//   weights (wpbT or wdbT), so no shared memory is held for them.
// - two consumer warpgroups, each on 64 of the tile's 128 cells, running
//   the heads one after the other: the 3×3 product on wgmma m64n256k16
//   (bf16 in, f32 accumulators, 128 registers per thread, setmaxnreg 232).
//   The ReLU'd accumulators are rounded to bf16 and repacked in registers
//   as the A fragments of the 1×1 conv, which is wgmma too (m64n72k16 for
//   loc, m64n32k16 for ids). Each thread holds 18 (or 8) of a cell's
//   logits; a first-max argmax over the four threads of a row gives the
//   cell's pix, or its id, confidence and dustbin logit, and one thread per
//   cell claims.
// - claims reduce through the shared 64-bit key (decode_common.cuh): the
//   block's table, merged into the image's scratch row when the block's
//   range moves to the next image, and the block that completes an image
//   writes its keypoints.
//
// Traffic. Each weight tile that reaches a block feeds its 128 cells. At
// N=256 on a 30×40 grid there are 2560 tiles; each reads the 1.18 MB of
// whT and 52 KB of 1×1 weights once (3.16 GB per batch, nearly all from
// L2) and gathers its trunk box 36 times (9 taps × 2 heads, 1.51 GB per
// batch). A stage brings 48 KB for 4.2 MFLOP. Tried and measured slower
// on the H100 (PERF.md): 8×8 tiles with one warpgroup per head (6.3 GB of
// weight reads per batch), and 2-block clusters that multicast each
// weight tile to both blocks. The heads do not share a stage's trunk box:
// both heads' accumulators for the same rows do not fit in the register
// file, and the 8×8 design, which did share it, was slower. Loading the
// trunk for the first head only (scripts/probe_fused_trunk_once.py) saves
// 1-2%. Device launches per call: the scratch memset and this kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <math_constants.h>
#include <cstdint>

#include "decode_common.cuh"

namespace {

constexpr int kThreads = 384;     // warpgroups 0, 1: consumers; 2: producer
constexpr int kTileY = 16, kTileX = 8;
constexpr int kTileM = kTileY * kTileX;  // 128 cells: 64 rows per consumer warpgroup
constexpr int kChunkK = 64;       // K per stage: 64 bf16 = one 128-byte row
constexpr int kHead = 256;        // width of each 3×3 head
constexpr int kLocN = 72;         // 65 loc channels padded to a multiple of 8
constexpr int kIdsN = 32;         // n_ids + 1 <= 32
constexpr int kStages = 4;
constexpr int kABytes = kTileM * kChunkK * 2;           // 16 KB
constexpr int kBBytes = kHead * kChunkK * 2;            // 32 KB: one head
constexpr int kStageBytes = kABytes + kBBytes;
// A head's 1×1 weights take one stage after its 18 K slices: 4 K-chunks.
constexpr int kWpbBytes = (kHead / kChunkK) * kLocN * 128;
static_assert(kWpbBytes <= kStageBytes, "1x1 weights exceed a stage");

// Offsets in the 1024-byte-aligned dynamic shared memory.
constexpr int kOffBias = kStages * kStageBytes;  // bpa, bda (256), bpb (72), bdb (32)
constexpr int kOffRows = kOffBias + (2 * kHead + kLocN + kIdsN) * 4;
constexpr int kOffTable = kOffRows + 4 * kTileM * 4;  // pix, id, conf, dust
constexpr int kOffBar = kOffTable + dc::kMaxIds * 8;
constexpr int kOffLast = kOffBar + 2 * kStages * 8;
constexpr int kSmemBytes = kOffLast + 16 + 1024;  // + alignment slack
static_assert(kSmemBytes <= 232448, "more shared memory than a block may have");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// A wait that has not completed after 2^30 polls (far beyond any real
// wait) traps, so a broken pipeline ends the launch with an error instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows,
// 128-byte swizzle, 8-row groups 1024 bytes apart (tile base 1024-aligned).
// Adding 2 moves the start 32 bytes (16 bf16) along K.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins a register to this point, so no use of an asynchronously written
// accumulator is moved across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D(64×256) += A(64×16) · B(16×256), both from shared memory, K-major SW128.
__device__ __forceinline__ void wgmma_m64n256k16_ss(float* d, uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64×72) += A(64×16, registers) · B(16×72, shared memory, K-major SW128).
__device__ __forceinline__ void wgmma_m64n72k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64×32) += A(64×16, registers) · B(16×32, shared memory, K-major SW128).
__device__ __forceinline__ void wgmma_m64n32k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
fused_head_decode_kernel(const __grid_constant__ CUtensorMap tm_trunk,
                         const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_wpb,
                         const __grid_constant__ CUtensorMap tm_wdb,
                         const float* __restrict__ bias, int n, int hc, int wc, int cin,
                         int n_ids, int gate, float min_margin,
                         unsigned long long* __restrict__ scratch,
                         float* __restrict__ kpts, bool* __restrict__ valid) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* bias_s = reinterpret_cast<float*>(sm + kOffBias);
  int* row_pix = reinterpret_cast<int*>(sm + kOffRows);
  int* row_id = row_pix + kTileM;
  float* row_conf = reinterpret_cast<float*>(row_id + kTileM);
  float* row_dust = row_conf + kTileM;
  unsigned long long* table = reinterpret_cast<unsigned long long*>(sm + kOffTable);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kOffBar);
  uint64_t* empty = full + kStages;
  int* last = reinterpret_cast<int*>(sm + kOffLast);

  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * kHead + kLocN + kIdsN; i += kThreads) bias_s[i] = bias[i];
  if (tid < dc::kMaxIds) table[tid] = 0ull;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_x = (wc + kTileX - 1) / kTileX;
  const int per_img = ((hc + kTileY - 1) / kTileY) * tiles_x;
  const long long items = static_cast<long long>(n) * per_img;
  long long begin, end;
  dc::item_range(items, blockIdx.x, gridDim.x, begin, end);
  const int chunks = 9 * cin / kChunkK, per_tap = cin / kChunkK;
  const int wg = tid / 128;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int g = 0;
      for (long long item = begin; item < end; ++item) {
        const int img = static_cast<int>(item / per_img), t = static_cast<int>(item % per_img);
        const int y0 = (t / tiles_x) * kTileY, x0 = (t % tiles_x) * kTileX;
        for (int h = 0; h < 2; ++h) {
          for (int kc = 0; kc < chunks; ++kc, ++g) {
            const int s = g % kStages, ph = (g / kStages) & 1;
            mbar_wait(empty + s, ph ^ 1);
            unsigned char* st = sm + s * kStageBytes;
            mbar_expect_tx(full + s, kStageBytes);
            const int tap = kc / per_tap;
            tma_load_4d(st, &tm_trunk, full + s, (kc % per_tap) * kChunkK,
                        x0 + tap % 3 - 1, y0 + tap / 3 - 1, img);
            tma_load_2d(st + kABytes, &tm_w, full + s, kc * kChunkK, h * kHead);
          }
          const int s = g % kStages, ph = (g / kStages) & 1;  // the head's 1×1 weights
          mbar_wait(empty + s, ph ^ 1);
          unsigned char* st = sm + s * kStageBytes;
          const CUtensorMap* map = h == 0 ? &tm_wpb : &tm_wdb;
          const int rows = h == 0 ? kLocN : kIdsN;
          mbar_expect_tx(full + s, (kHead / kChunkK) * rows * 128);
          for (int c = 0; c < kHead / kChunkK; ++c)
            tma_load_2d(st + c * rows * 128, map, full + s, c * kChunkK, 0);
          ++g;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid % 128) / 32, lane = tid % 32, q = lane % 4;
    // this thread's rows of the tile: row0 and row0 + 8
    const int row0 = wg * 64 + warp * 16 + lane / 4;
    int g = 0, done = 0;  // done: tiles of the current image in the table
    for (long long item = begin; item < end; ++item) {
      const int img = static_cast<int>(item / per_img), t = static_cast<int>(item % per_img);
      const int y0 = (t / tiles_x) * kTileY, x0 = (t % tiles_x) * kTileX;

      for (int h = 0; h < 2; ++h) {
        // 3×3 conv of head h on this warpgroup's 64 cells: im2col(64 × K) @ W(K × 256)
        const float* hbias = bias_s + h * kHead;
        float acc[128];
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
        for (int kc = 0; kc < chunks; ++kc, ++g) {
          const int s = g % kStages;
          mbar_wait(full + s, (g / kStages) & 1);
          const unsigned char* st = sm + s * kStageBytes;
          const uint64_t da = desc_sw128(st + wg * (kABytes / 2));
          const uint64_t db = desc_sw128(st + kABytes);
          fence_regs<128>(acc);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kChunkK / 16; ++ks)
            wgmma_m64n256k16_ss(acc, da + 2 * ks, db + 2 * ks, 1);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs<128>(acc);
          if (kc > 0) mbar_arrive(empty + (g - 1) % kStages);
        }
        wgmma_wait<0>();
        fence_regs<128>(acc);
        mbar_arrive(empty + (g - 1) % kStages);

        // bias, ReLU, bf16: the accumulators become the 1×1 conv's A fragments
        uint32_t a[64];
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int col = 8 * j + 2 * q;
            a[4 * (j / 2) + 2 * (j % 2) + i] =
                pack_bf16(fmaxf(acc[4 * j + 2 * i] + hbias[col], 0.f),
                          fmaxf(acc[4 * j + 2 * i + 1] + hbias[col + 1], 0.f));
          }

        const int ws = g % kStages;  // the stage that holds the head's 1×1 weights
        mbar_wait(full + ws, (g / kStages) & 1);
        const unsigned char* wst = sm + ws * kStageBytes;
        ++g;
        if (h == 0) {  // loc: 65 logits → pix
          float l[kLocN / 2];
#pragma unroll
          for (int i = 0; i < kLocN / 2; ++i) l[i] = 0.f;
          fence_regs<kLocN / 2>(l);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kHead / 16; ++ks)
            wgmma_m64n72k16_rs(l, a + 4 * ks,
                               desc_sw128(wst + (ks / 4) * kLocN * 128) + 2 * (ks % 4), 1);
          wgmma_commit();
          wgmma_wait<0>();
          mbar_arrive(empty + ws);
          fence_regs<kLocN / 2>(l);
          fence_regs<64>(a);  // the A fragments were read asynchronously
          const float* b = bias_s + 2 * kHead;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = -CUDART_INF_F;
            int idx = 1 << 30;
#pragma unroll
            for (int j = 0; j < kLocN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = 8 * j + 2 * q + e;
                if (col < dc::kLocChannels) dc::merge(v, idx, l[4 * j + 2 * i + e] + b[col], col);
              }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1)
              dc::merge(v, idx, __shfl_xor_sync(0xffffffffu, v, off),
                        __shfl_xor_sync(0xffffffffu, idx, off));
            if (q == 0) row_pix[row0 + 8 * i] = idx;
          }
        } else {  // ids: n_ids + 1 logits → id, confidence, dustbin logit
          float l[kIdsN / 2];
#pragma unroll
          for (int i = 0; i < kIdsN / 2; ++i) l[i] = 0.f;
          fence_regs<kIdsN / 2>(l);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kHead / 16; ++ks)
            wgmma_m64n32k16_rs(l, a + 4 * ks,
                               desc_sw128(wst + (ks / 4) * kIdsN * 128) + 2 * (ks % 4), 1);
          wgmma_commit();
          wgmma_wait<0>();
          mbar_arrive(empty + ws);
          fence_regs<kIdsN / 2>(l);
          fence_regs<64>(a);  // the A fragments were read asynchronously
          const float* b = bias_s + 2 * kHead + kLocN;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = -CUDART_INF_F, dust = -CUDART_INF_F;
            int idx = 1 << 30;
#pragma unroll
            for (int j = 0; j < kIdsN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = 8 * j + 2 * q + e;
                const float x = l[4 * j + 2 * i + e] + b[col];
                if (col <= n_ids) dc::merge(v, idx, x, col);
                if (col == n_ids) dust = x;
              }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              dc::merge(v, idx, __shfl_xor_sync(0xffffffffu, v, off),
                        __shfl_xor_sync(0xffffffffu, idx, off));
              dust = fmaxf(dust, __shfl_xor_sync(0xffffffffu, dust, off));
            }
            if (q == 0) {
              row_id[row0 + 8 * i] = idx;
              row_conf[row0 + 8 * i] = v;
              row_dust[row0 + 8 * i] = dust;
            }
          }
        }
      }
      consumers_sync();  // the tile's rows are complete

      if (tid < kTileM) {
        const int y = y0 + tid / kTileX, x = x0 + tid % kTileX;
        if (y < hc && x < wc) {
          const int id = dc::claim(row_pix[tid], row_id[tid], row_conf[tid], row_dust[tid],
                                   n_ids, gate != 0, min_margin);
          dc::offer(table, id, row_conf[tid], y * wc + x, row_pix[tid]);
        }
      }
      consumers_sync();  // table complete
      ++done;
      if (item + 1 == end || (item + 1) / per_img != img) {  // publish the image's claims
        unsigned long long* row = scratch + static_cast<size_t>(img) * (n_ids + 1);
        dc::flush(table, row, n_ids, tid);
        consumers_sync();
        if (tid == 0) *last = dc::count_items(row, n_ids, done, per_img);
        consumers_sync();
        if (*last)
          dc::finish_image(row, n_ids, wc, kpts + static_cast<size_t>(img) * n_ids * 2,
                           valid + static_cast<size_t>(img) * n_ids, tid);
        done = 0;
      }
    }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up in the libcuda that the CUDA runtime
// has loaded (no link against libcuda needed).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapL2promotion promo) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  EncodeTiled fn = encode_tiled();
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                  strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, promo,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// trunk (n, hc, wc, cin) bf16 contiguous, 16-byte aligned, cin % 64 == 0;
// whT (512, 9·cin) bf16; wpbT (72, 256) and wdbT (32, 256) bf16, rows past
// 65 and n_ids+1 zero; bias (256 + 256 + 72 + 32) f32 = bpa, bda, bpb, bdb
// zero-padded (pack_head_params). scratch (n, n_ids+1) uint64, zero; kpts
// (n, n_ids, 2) f32, valid (n, n_ids) bool. Returns cudaGetLastError(), or
// -1 if a tensor map could not be encoded.
extern "C" int dc_fused_head_decode(const void* trunk, const void* whT, const void* wpbT,
                                    const void* wdbT, const void* bias, int n, int hc,
                                    int wc, int cin, int n_ids, int gate, float min_margin,
                                    void* scratch, void* kpts, void* valid, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap tm_trunk, tm_w, tm_wpb, tm_wdb;
  const cuuint64_t tdims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(wc),
                               static_cast<cuuint64_t>(hc), static_cast<cuuint64_t>(n)};
  const cuuint64_t tstrides[3] = {static_cast<cuuint64_t>(cin) * 2,
                                  static_cast<cuuint64_t>(wc) * cin * 2,
                                  static_cast<cuuint64_t>(hc) * wc * cin * 2};
  const cuuint32_t tbox[4] = {kChunkK, kTileX, kTileY, 1};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(9 * cin), 2 * kHead};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(9 * cin) * 2};
  const cuuint32_t wbox[2] = {kChunkK, kHead};
  const cuuint64_t pdims[2] = {kHead, kLocN}, ddims[2] = {kHead, kIdsN};
  const cuuint64_t pstrides[1] = {kHead * 2};
  const cuuint32_t pbox[2] = {kChunkK, kLocN}, dbox[2] = {kChunkK, kIdsN};
  const auto promo = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  if (!encode(&tm_trunk, trunk, 4, tdims, tstrides, tbox, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode(&tm_w, whT, 2, wdims, wstrides, wbox, promo) ||
      !encode(&tm_wpb, wpbT, 2, pdims, pstrides, pbox, promo) ||
      !encode(&tm_wdb, wdbT, 2, ddims, pstrides, dbox, promo))
    return dc::kTensorMapError;

  int resident = 0;  // the grid: one block per SM
  const cudaError_t err =
      dc::resident_blocks(fused_head_decode_kernel, kThreads, kSmemBytes, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      static_cast<long long>(n) * ((hc + kTileY - 1) / kTileY) * ((wc + kTileX - 1) / kTileX);
  const int grid = static_cast<int>(items < resident ? items : resident);
  fused_head_decode_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tm_trunk, tm_w, tm_wpb, tm_wdb, static_cast<const float*>(bias), n, hc, wc,
      cin, n_ids, gate, min_margin, static_cast<unsigned long long*>(scratch),
      static_cast<float*>(kpts), static_cast<bool*>(valid));
  return static_cast<int>(cudaGetLastError());
}
