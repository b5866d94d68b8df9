// Conv epilogue: the conv bias, BatchNorm on the running statistics, ReLU
// and the 2×2 max-pool or ×2 nearest upsample that follows, in one pass
// over a bf16 channels_last convolution output. A second entry point does
// the same without BatchNorm (a block with no norm, as SuperPoint's): the
// bias, ReLU, then the pool or upsample.
//
// Replaces no TPU kernel. XLA fuses a ConvBNRelu block's elementwise tail
// into the convolution on the TPU; PyTorch runs cuDNN's convolution and
// then four passes over its output: the bias add_ that it issues after
// cuDNN, batch_norm, relu, and max_pool2d or the nearest upsample.
//
// Bound on an H100: memory. A block's conv output is read once and its
// output written once (a quarter of it after a pool, four times it after an
// upsample); the arithmetic is a dozen flops per element. At 256 frames the
// detector's ten blocks read 7.4 GB, about 2.2 ms at 3.35 TB/s.
//
// Numerics: ATen's chain, rounding for rounding. Per element, in float32:
//   t = bf16(c + b)                             the add_ (opmath float)
//   u = bf16(fma(w * (t - m), inv, s))          batch_norm_transform_input_
//                                               channels_last_kernel, whose
//                                               w*(x-m)*inv+s nvcc contracts
//   inv = rsqrtf(var + eps)                     ATen's batch_norm_calc_invstd
//   y = isnan(u) ? u : fmaxf(u, 0)              relu (clamp_min)
// then the max of the four (NaN propagates, as max_pool2d's does) or four
// copies. Without BatchNorm, y = isnan(t) ? t : fmaxf(t, 0), as conv2d
// with its bias, relu and the pool or upsample give. Each step's intrinsic
// is spelled out so that no contraction other than ATen's can happen.
// BatchNorm is not folded into the weights: that moves a rounding.
//
// Design: a thread owns one 16-byte vector of 8 channels at a time. The
// block is a multiple of C/8 threads and the grid's stride a multiple of
// the block, so a thread's channels never change: the block computes the
// per-channel constants once into shared memory, from the parameters' own
// pointers (no launch of its own), and each thread keeps its 8 channels'
// constants in registers. A grid-stride loop over as many blocks as fit on
// the card at once walks the output (pool) or the input (none, up), with
// the loads of 2 (pool: 8 vectors) or 4 vectors in flight per thread before
// any is used. No intermediate touches device memory. Device launches per
// call: this kernel. At N = 256 it runs at 81-85% of the bytes' bound on
// the three largest blocks (chip_smoke.py phase 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxThreads = 256;
constexpr int kMaxChannels = 8 * kMaxThreads;  // C/8 threads must fit a block
constexpr int kParams = 5;                     // conv bias, mean, inv, weight, shift
enum Then { kNone = 0, kPool = 1, kUp = 2 };

struct Channels {
  float cb[8], m[8], inv[8], w[8], s[8];
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kNorm>
__device__ __forceinline__ float epilogue1(float c, const Channels& p, int k) {
  const float t = bf16_round(__fadd_rn(c, p.cb[k]));
  if (!kNorm) return isnan(t) ? t : fmaxf(t, 0.f);
  const float u = bf16_round(__fmaf_rn(__fmul_rn(p.w[k], __fsub_rn(t, p.m[k])), p.inv[k], p.s[k]));
  return isnan(u) ? u : fmaxf(u, 0.f);
}

// The 8 channels of one pixel through the epilogue, as floats.
template <bool kNorm>
__device__ __forceinline__ void apply(const uint4& v, const Channels& p, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = epilogue1<kNorm>(t.x, p, 2 * i);
    f[2 * i + 1] = epilogue1<kNorm>(t.y, p, 2 * i + 1);
  }
}

// Exact: every value is a bf16 already.
__device__ __forceinline__ uint4 pack(const float f[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// max_pool2d's step: a larger value or a NaN replaces the running max.
__device__ __forceinline__ void max_into(float acc[8], const float f[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (f[k] > acc[k] || isnan(f[k])) acc[k] = f[k];
}

// x: (n, h, w, c) bf16, the conv output without its bias; y: (n, h/2, w/2, c)
// (kPool, floor), (n, 2h, 2w, c) (kUp) or (n, h, w, c). `items` counts the
// 16-byte vectors of y (kNone, kPool) or of x (kUp). Without kNorm the four
// BatchNorm pointers are not read.
template <int kThen, bool kNorm>
__global__ void __launch_bounds__(kMaxThreads)
conv_epilogue_kernel(const uint4* __restrict__ x, const __nv_bfloat16* __restrict__ conv_bias,
                     const float* __restrict__ mean, const float* __restrict__ var,
                     const float* __restrict__ weight, const float* __restrict__ shift,
                     float eps, int c, int h, int w, unsigned items, uint4* __restrict__ y) {
  extern __shared__ float smem[];  // kParams arrays of c floats (kNorm), else one
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    smem[i] = __bfloat162float(conv_bias[i]);
    if (kNorm) {
      smem[c + i] = mean[i];
      smem[2 * c + i] = rsqrtf(__fadd_rn(var[i], eps));
      smem[3 * c + i] = weight[i];
      smem[4 * c + i] = shift[i];
    }
  }
  __syncthreads();
  const unsigned groups = static_cast<unsigned>(c) / 8u;
  const unsigned g = threadIdx.x % groups;
  Channels p;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ch = 8 * g + k;
    p.cb[k] = smem[ch];
    if (kNorm) {
      p.m[k] = smem[c + ch];
      p.inv[k] = smem[2 * c + ch];
      p.w[k] = smem[3 * c + ch];
      p.s[k] = smem[4 * c + ch];
    }
  }

  constexpr int kU = kThen == kPool ? 2 : 4;  // a pooled vector reads four
  constexpr int kLoads = kThen == kPool ? 4 : 1;
  const unsigned stride = gridDim.x * blockDim.x;
  const unsigned row = static_cast<unsigned>(w) * groups;  // vectors in a row of x
  const unsigned ho = static_cast<unsigned>(h) / 2u, wo = static_cast<unsigned>(w) / 2u;
  for (unsigned i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < items; i0 += kU * stride) {
    uint4 in[kU][kLoads];
    size_t at[kU];  // the first vector read (kNone, kPool) or written (kUp)
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const unsigned i = i0 + u * stride;
      if (i >= items) break;
      const unsigned pix = (i - g) / groups;  // a pixel of y (kNone, kPool) or of x (kUp)
      if (kThen == kNone) {
        at[u] = i;
      } else if (kThen == kPool) {
        const unsigned r = pix / wo, col = pix - r * wo;  // r = n·ho + oh
        const unsigned n = r / ho, hr = 2u * (r - n * ho);
        at[u] = ((static_cast<size_t>(n) * h + hr) * w + 2u * col) * groups + g;
      } else {
        const unsigned r = pix / static_cast<unsigned>(w);  // r = n·h + row
        const unsigned col = pix - r * static_cast<unsigned>(w);
        at[u] = ((2 * static_cast<size_t>(r)) * (2u * w) + 2u * col) * groups + g;
      }
      if (kThen == kPool) {
        in[u][0] = __ldcs(x + at[u]);
        in[u][1] = __ldcs(x + at[u] + groups);
        in[u][2] = __ldcs(x + at[u] + row);
        in[u][3] = __ldcs(x + at[u] + row + groups);
      } else {
        in[u][0] = __ldcs(x + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const unsigned i = i0 + u * stride;
      if (i >= items) break;
      float f[8];
      apply<kNorm>(in[u][0], p, f);
      if (kThen == kNone) {
        y[i] = pack(f);
      } else if (kThen == kPool) {
#pragma unroll
        for (int l = 1; l < kLoads; ++l) {
          float e[8];
          apply<kNorm>(in[u][l], p, e);
          max_into(f, e);
        }
        y[i] = pack(f);
      } else {
        const uint4 v = pack(f);
        const size_t down = 2 * row;  // vectors in a row of y
        y[at[u]] = v;
        y[at[u] + groups] = v;
        y[at[u] + down] = v;
        y[at[u] + down + groups] = v;
      }
    }
  }
}

// Blocks of the kernel in mode (kThen, kNorm) that fit on the current device
// at once, with kMaxThreads threads and the largest shared memory a call asks
// for: worked out once per device and mode, since the host cost of a call
// matters for small layers.
template <int kThen, bool kNorm>
cudaError_t resident_blocks(int& blocks) {
  static std::mutex mu;
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    const int smem = (kNorm ? kParams : 1) * kMaxChannels * static_cast<int>(sizeof(float));
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv_epilogue_kernel<kThen, kNorm>, kMaxThreads, smem);
    if (err != cudaSuccess) return err;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  blocks = cache[dev];
  return cudaSuccess;
}

template <int kThen, bool kNorm>
int launch(const void* x, const void* conv_bias, const void* mean, const void* var,
           const void* weight, const void* shift, float eps, int n, int c, int h, int w,
           void* y, cudaStream_t stream) {
  const long long groups = c / 8;
  long long pixels = static_cast<long long>(n) * h * w;
  if (kThen == kPool) pixels = static_cast<long long>(n) * (h / 2) * (w / 2);
  const long long items = pixels * groups;
  if (items <= 0) return static_cast<int>(cudaGetLastError());
  int resident = 0;
  const cudaError_t err = resident_blocks<kThen, kNorm>(resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = static_cast<int>(groups * (kMaxThreads / groups));
  const long long want = (items + threads - 1) / threads;
  const int grid = static_cast<int>(want < resident ? want : resident);
  const int smem = (kNorm ? kParams : 1) * c * static_cast<int>(sizeof(float));
  conv_epilogue_kernel<kThen, kNorm><<<grid, threads, smem, stream>>>(
      static_cast<const uint4*>(x), static_cast<const __nv_bfloat16*>(conv_bias),
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const float*>(weight), static_cast<const float*>(shift), eps, c, h, w,
      static_cast<unsigned>(items), static_cast<uint4*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, c, h, w) bf16 channels_last, 16-byte aligned, c a multiple of 8 up
// to 2048; conv_bias (c) bf16; mean, var, weight, shift (c) f32; then 0
// (none), 1 (2×2 max-pool, floor) or 2 (×2 nearest); y channels_last of the
// matching shape; the wrapper keeps the vectors under 2^31. Returns
// cudaGetLastError().
extern "C" int dc_conv_epilogue(const void* x, const void* conv_bias, const void* mean,
                                const void* var, const void* weight, const void* shift,
                                float eps, int n, int c, int h, int w, int then, void* y,
                                void* stream) {
  if (c <= 0 || c % 8 != 0 || c > kMaxChannels || then < kNone || then > kUp)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (then == kPool)
    return launch<kPool, true>(x, conv_bias, mean, var, weight, shift, eps, n, c, h, w, y, s);
  if (then == kUp)
    return launch<kUp, true>(x, conv_bias, mean, var, weight, shift, eps, n, c, h, w, y, s);
  return launch<kNone, true>(x, conv_bias, mean, var, weight, shift, eps, n, c, h, w, y, s);
}

// The same pass without BatchNorm: the conv bias, ReLU, then `then`.
extern "C" int dc_conv_bias_relu(const void* x, const void* conv_bias, int n, int c, int h,
                                 int w, int then, void* y, void* stream) {
  if (c <= 0 || c % 8 != 0 || c > kMaxChannels || then < kNone || then > kUp)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (then == kPool)
    return launch<kPool, false>(x, conv_bias, nullptr, nullptr, nullptr, nullptr, 0.f, n, c,
                                h, w, y, s);
  if (then == kUp)
    return launch<kUp, false>(x, conv_bias, nullptr, nullptr, nullptr, nullptr, 0.f, n, c, h,
                              w, y, s);
  return launch<kNone, false>(x, conv_bias, nullptr, nullptr, nullptr, nullptr, 0.f, n, c, h,
                              w, y, s);
}

extern "C" const char* dc_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
