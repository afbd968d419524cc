// Exact int8 convolutions for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// They replace what the JAX package's QConv runs on its int8 path
// (cv_diffusion_tpu/ops/qconv.py:145-176): XLA's int8 conv_general_dilated
// with preferred_element_type=int32 (:104-110, 174). That is not a Pallas
// kernel, so no TPU kernel is ported here; the port needs a kernel all the
// same, because PyTorch has no int8 convolution on the card and a float32
// convolution of int8 values is not exact once a partial sum passes 2^24
// (a product is at most 127^2 = 16,129; the small UNet's widest 1x1 has
// K = 2,048 and its 3x3 Up/Downsample convs K = 2,304). Three entries, each
// for float32 and bfloat16 compute, each equal to its plain PyTorch version
// (cv_diffusion_tpu_torch/ops/qconv.py) bit for bit:
//
//   qconv_quantize_*   x [N, C, H, W] -> int8 [N, H, W, Cp], Cp = C rounded up
//                      to a multiple of 4 (the padding channels 0):
//                      q = clip(rint(x / s_x), -127, 127), s_x =
//                      max(amax, 1e-6) * float(1/127). The product needs the
//                      channel (K) axis contiguous, so the NCHW -> NHWC
//                      transpose is done in the same pass, through a 32 x 32
//                      tile in shared memory (reads along pixels, writes
//                      along channels).
//   qconv_dense_*      1x1 and 3x3, stride 1 or 2, zero padding `pad`:
//                      acc[n, o, p] = sum over taps and channels of
//                      xq * wq, wq laid out [O, K, K, Cp].
//   qconv_depthwise_*  3x3 depthwise, stride 1 or 2, padding 1, wq [9, Cp].
//
// Both convolutions sum in int32, exactly and so in any order, and apply the
// epilogue of the plain version in its order: y = float(acc) * (s_x *
// s_w[o]), the scale product formed first, rounded to the compute dtype,
// then + bias in that dtype. Every multiply and add is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn): nvcc would otherwise contract y * s + b
// into one FMA, which rounds once where PyTorch rounds twice. The divide is
// __fdiv_rn and the rounding rintf (half to even); the file is built without
// --use_fast_math. s_x is computed from the device scalar amax in every
// thread that needs it, the same way, so no host sync is needed and the
// sampler's CUDA graph captures the path.
//
// What bounds them on an H100 SXM (3.35 TB/s, 1,979 dense int8 TOP/s on the
// tensor cores; __dp4a runs on the CUDA cores at a small fraction of that).
// At the small UNet's widest 1x1 (the decoder's project, 2,048 -> 512 at
// 32 x 32, batch 1) the product is 2 * 1024 * 2048 * 512 = 2.1 G int8
// operations, ~1.1 us at the tensor-core rate, against ~5.2 MB moved
// (2.1 MB of int8 input, 1.0 MB of int8 weights, 2.1 MB of f32 output),
// ~1.6 us: bound by bytes, as chip_smoke.py's qconv_work counts it; at
// batch 1 most convolutions of the UNet are bound by bytes, and by the
// launch. This first version is the simple tiling that
// is right: each 256-thread block computes a 64-pixel x 64-channel tile of
// the output, stages 32 channels of one tap at a time for both operands in
// shared memory as 32-bit words, and each thread sums a 4 x 4 sub-tile with
// __dp4a (four int8 products a instruction). It reads the input once per
// 64 output channels and per tap (no reuse across the taps of a 3x3), and
// leaves the tensor cores idle: mma.sync m16n8k32 s8 (its .row.col operands
// are why the activations are pixel-major) and reuse of the staged pixels
// across taps are the work for a later kernel PR. The depthwise entry is one
// thread per output pixel and group of four channels, nine 32-bit loads and
// 36 integer products; it is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInv127 = 1.0f / 127.0f;   // float(1/127), as JAX's compiled scales
constexpr float kActFloor = 1e-6f;
constexpr int kTileM = 64;      // output pixels a dense block
constexpr int kTileN = 64;      // output channels a dense block
constexpr int kTileWords = 8;   // 32-bit words (4 int8 channels each) staged a step
constexpr int kThreads = 256;

__device__ __forceinline__ float act_scale(const float* amax) {
  return __fmul_rn(fmaxf(*amax, kActFloor), kInv127);
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ signed char quantize_one(float x, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rn(q));
}

// float(acc) * scale, rounded to the output dtype, then + bias in that dtype
__device__ __forceinline__ void store(float* out, int acc, float scale, const float* bias, int c) {
  float y = __fmul_rn(__int2float_rn(acc), scale);
  if (bias != nullptr) y = __fadd_rn(y, bias[c]);
  *out = y;
}

__device__ __forceinline__ void store(__nv_bfloat16* out, int acc, float scale,
                                      const __nv_bfloat16* bias, int c) {
  __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), scale));
  if (bias != nullptr) y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), __bfloat162float(bias[c])));
  *out = y;
}

// grid (ceil(HW / 32), ceil(Cp / 32), N), block (32, 8)
template <typename T>
__global__ void __launch_bounds__(kThreads) quantize_kernel(const T* __restrict__ x,
                                                           const float* __restrict__ amax,
                                                           signed char* __restrict__ out, int C,
                                                           int HW, int Cp) {
  __shared__ signed char tile[32][33];
  const int n = blockIdx.z, p0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float s = act_scale(amax);
  const T* xn = x + static_cast<size_t>(n) * C * HW;
  for (int r = 0; r < 4; ++r) {
    const int c = c0 + ty + 8 * r, p = p0 + tx;
    signed char q = 0;
    if (c < C && p < HW) q = quantize_one(load_f32(xn + static_cast<size_t>(c) * HW + p), s);
    tile[ty + 8 * r][tx] = q;
  }
  __syncthreads();
  signed char* on = out + static_cast<size_t>(n) * HW * Cp;
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + ty + 8 * r, c = c0 + tx;
    if (p < HW && c < Cp) on[static_cast<size_t>(p) * Cp + c] = tile[tx][ty + 8 * r];
  }
}

// grid (ceil(M / 64), ceil(O / 64)), M = N * OH * OW; 256 threads
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_kernel(const signed char* __restrict__ xq, const signed char* __restrict__ wq,
                 const float* __restrict__ amax, const float* __restrict__ s_w,
                 const T* __restrict__ bias, T* __restrict__ out, int N, int H, int W, int Cp,
                 int O, int K, int stride, int pad, int OH, int OW) {
  __shared__ int sA[kTileWords][kTileM];
  __shared__ int sB[kTileWords][kTileN];
  const int tid = threadIdx.x;
  const int tm = tid & 15, tn = tid >> 4;    // this thread's 4 x 4 outputs
  const int m0 = blockIdx.x * kTileM, o0 = blockIdx.y * kTileN;
  const int P = OH * OW, M = N * P, words = Cp >> 2;

  // loader: row `lrow` of both tiles (a pixel of A, an output channel of B),
  // words lw and lw + 4 of each step
  const int lrow = tid >> 2, lw = tid & 3;
  const int lm = m0 + lrow, lo = o0 + lrow;
  const bool m_ok = lm < M, o_ok = lo < O;
  int ln = 0, loh = 0, low = 0;
  if (m_ok) {
    ln = lm / P;
    const int r = lm - ln * P;
    loh = r / OW;
    low = r - loh * OW;
  }

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kh = 0; kh < K; ++kh) {
    for (int kw = 0; kw < K; ++kw) {
      const int ih = loh * stride - pad + kh, iw = low * stride - pad + kw;
      const bool in = m_ok && ih >= 0 && ih < H && iw >= 0 && iw < W;
      const int* xrow = reinterpret_cast<const int*>(
          xq + ((static_cast<size_t>(ln) * H + (in ? ih : 0)) * W + (in ? iw : 0)) * Cp);
      const int* wrow = reinterpret_cast<const int*>(
          wq + ((static_cast<size_t>(o_ok ? lo : 0) * K + kh) * K + kw) * Cp);
      for (int w0 = 0; w0 < words; w0 += kTileWords) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int word = lw + 4 * h, c = w0 + word;
          sA[word][lrow] = (in && c < words) ? xrow[c] : 0;
          sB[word][lrow] = (o_ok && c < words) ? wrow[c] : 0;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kTileWords; ++k) {
          int a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = sA[k][tm + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = sB[k][tn + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  const float s = act_scale(amax);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + tn + 16 * j;
    if (o >= O) continue;
    const float scale = __fmul_rn(s, s_w[o]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + tm + 16 * i;
      if (m >= M) continue;
      const int n = m / P;
      store(out + (static_cast<size_t>(n) * O + o) * P + (m - n * P), acc[i][j], scale, bias, o);
    }
  }
}

// one thread per output pixel and group of 4 channels, the pixel fastest
template <typename T>
__global__ void __launch_bounds__(kThreads)
    depthwise_kernel(const signed char* __restrict__ xq, const signed char* __restrict__ wq,
                     const float* __restrict__ amax, const float* __restrict__ s_w,
                     const T* __restrict__ bias, T* __restrict__ out, int N, int H, int W, int C,
                     int Cp, int stride, int OH, int OW) {
  const int groups = Cp >> 2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * groups * OH * OW) return;
  const int ow = static_cast<int>(idx % OW);
  long long r = idx / OW;
  const int oh = static_cast<int>(r % OH);
  r /= OH;
  const int g = static_cast<int>(r % groups);
  const int n = static_cast<int>(r / groups);
  int acc[4] = {0, 0, 0, 0};
  for (int kh = 0; kh < 3; ++kh) {
    const int ih = oh * stride - 1 + kh;
    if (ih < 0 || ih >= H) continue;
    for (int kw = 0; kw < 3; ++kw) {
      const int iw = ow * stride - 1 + kw;
      if (iw < 0 || iw >= W) continue;
      const int xw = *reinterpret_cast<const int*>(
          xq + ((static_cast<size_t>(n) * H + ih) * W + iw) * Cp + 4 * g);
      const int ww = *reinterpret_cast<const int*>(wq + (kh * 3 + kw) * Cp + 4 * g);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        acc[l] += static_cast<int>(static_cast<signed char>(xw >> (8 * l))) *
                  static_cast<int>(static_cast<signed char>(ww >> (8 * l)));
    }
  }
  const float s = act_scale(amax);
  const size_t P = static_cast<size_t>(OH) * OW;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int c = 4 * g + l;
    if (c >= C) break;
    store(out + (static_cast<size_t>(n) * C + c) * P + static_cast<size_t>(oh) * OW + ow, acc[l],
          __fmul_rn(s, s_w[c]), bias, c);
  }
}

template <typename T>
cudaError_t quantize(const void* x, const void* amax, void* out, int N, int C, int HW, int Cp,
                     void* stream) {
  if (N == 0 || HW == 0 || Cp == 0) return cudaSuccess;
  const dim3 grid((HW + 31) / 32, (Cp + 31) / 32, N), block(32, 8);
  quantize_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(amax), static_cast<signed char*>(out), C,
      HW, Cp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dense(const void* xq, const void* wq, const void* amax, const void* s_w,
                  const void* bias, void* out, int N, int H, int W, int Cp, int O, int K,
                  int stride, int pad, int OH, int OW, void* stream) {
  const long long M = static_cast<long long>(N) * OH * OW;
  if (M == 0 || O == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>((M + kTileM - 1) / kTileM), (O + kTileN - 1) / kTileN);
  dense_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(xq), static_cast<const signed char*>(wq),
      static_cast<const float*>(amax), static_cast<const float*>(s_w),
      static_cast<const T*>(bias), static_cast<T*>(out), N, H, W, Cp, O, K, stride, pad, OH, OW);
  return cudaGetLastError();
}

template <typename T>
cudaError_t depthwise(const void* xq, const void* wq, const void* amax, const void* s_w,
                      const void* bias, void* out, int N, int H, int W, int C, int Cp,
                      int stride, int OH, int OW, void* stream) {
  const long long threads = static_cast<long long>(N) * (Cp / 4) * OH * OW;
  if (threads == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  depthwise_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(xq), static_cast<const signed char*>(wq),
      static_cast<const float*>(amax), static_cast<const float*>(s_w),
      static_cast<const T*>(bias), static_cast<T*>(out), N, H, W, C, Cp, stride, OH, OW);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int qconv_quantize_f32(const void* x, const void* amax, void* out, int N, int C, int HW, int Cp,
                       void* stream) {
  return quantize<float>(x, amax, out, N, C, HW, Cp, stream);
}

int qconv_quantize_bf16(const void* x, const void* amax, void* out, int N, int C, int HW, int Cp,
                        void* stream) {
  return quantize<__nv_bfloat16>(x, amax, out, N, C, HW, Cp, stream);
}

int qconv_dense_f32(const void* xq, const void* wq, const void* amax, const void* s_w,
                    const void* bias, void* out, int N, int H, int W, int Cp, int O, int K,
                    int stride, int pad, int OH, int OW, void* stream) {
  return dense<float>(xq, wq, amax, s_w, bias, out, N, H, W, Cp, O, K, stride, pad, OH, OW,
                      stream);
}

int qconv_dense_bf16(const void* xq, const void* wq, const void* amax, const void* s_w,
                     const void* bias, void* out, int N, int H, int W, int Cp, int O, int K,
                     int stride, int pad, int OH, int OW, void* stream) {
  return dense<__nv_bfloat16>(xq, wq, amax, s_w, bias, out, N, H, W, Cp, O, K, stride, pad, OH,
                              OW, stream);
}

int qconv_depthwise_f32(const void* xq, const void* wq, const void* amax, const void* s_w,
                        const void* bias, void* out, int N, int H, int W, int C, int Cp,
                        int stride, int OH, int OW, void* stream) {
  return depthwise<float>(xq, wq, amax, s_w, bias, out, N, H, W, C, Cp, stride, OH, OW, stream);
}

int qconv_depthwise_bf16(const void* xq, const void* wq, const void* amax, const void* s_w,
                         const void* bias, void* out, int N, int H, int W, int C, int Cp,
                         int stride, int OH, int OW, void* stream) {
  return depthwise<__nv_bfloat16>(xq, wq, amax, s_w, bias, out, N, H, W, C, Cp, stride, OH, OW,
                                  stream);
}

const char* qconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
