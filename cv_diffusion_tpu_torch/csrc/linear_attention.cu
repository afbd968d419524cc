// Linear attention forward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
//   out = phi(Q) (phi(K)^T V) / (phi(Q) . sum_n phi(K) + eps),  phi = elu + 1
//
// per batch element and head, on q, k, v, out laid out [B, N, H, D].
//
// Replaces the TPU kernel `linear_attention_pallas`
// (cv_diffusion_tpu/ops/pallas_attention.py:82). That kernel packs the heads
// into the TPU's 128 lanes, masks the cross-head blocks of one wide D x D
// accumulator and walks N on a sequential grid axis, padding K with -30. None
// of that carries over: here every (batch, head) pair is its own set of
// blocks, the ragged N edge is masked, and the reduction over N runs on many
// blocks at once.
//
// What bounds it on an H100: at the serving shape [B, 1024, 4, 32] in f32 one
// image is about 17 MFLOP against 2 MiB moved (q, k, v read once, out written
// once), so it is memory-bound -- about 0.63 us per image at 3.35 TB/s -- and
// at these sizes the launch cost of a few microseconds dominates. The design
// reads K and V once and Q once, keeps kv in shared memory, and uses two
// launches in all:
//
//   A (reduce): grid (B*H, S). Block s forms phi(K) and V for its chunk of
//     N in f32 and writes a partial kv [D x D] and ksum [D] to scratch
//     [B, H, S, D, D+1] (ksum in the last column).
//   B (apply):  grid (B*H, N tiles). Each block sums the S partials in a fixed
//     order into shared memory (no atomics: reruns are bit-identical), then
//     writes phi(q) kv / (phi(q) . ksum + eps) for its rows in q's dtype.
//
// D is 32, 64 or 128; any H and N. Inputs are f32 or bf16, accumulation is
// f32. The entry points launch on the caller's stream and return the
// cudaError_t of the launches; they allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceRows = 32;  // rows of K/V staged in shared memory at a time

__device__ __forceinline__ float phi(float x) { return x > 0.f ? x + 1.f : expf(x); }

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Kernel A. Thread (warp w, lane l) owns kv rows w + 8*i and columns l + 32*j.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
reduce_kv(const T* __restrict__ k, const T* __restrict__ v, float* __restrict__ part,
          int N, int H, int S, int chunk) {
  constexpr int RR = D / kWarps;
  constexpr int CC = D / 32;
  __shared__ float ks[kReduceRows][D];
  __shared__ float vs[kReduceRows][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head_base = (static_cast<size_t>(b) * N * H + h) * D;
  const int n_begin = s * chunk;
  const int n_end = min(N, n_begin + chunk);

  float acc[RR][CC];
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int j = 0; j < CC; ++j) acc[i][j] = 0.f;
  float ksum = 0.f;  // threads t < D own ksum[t]

  for (int base = n_begin; base < n_end; base += kReduceRows) {
    const int rows = min(kReduceRows, n_end - base);
    for (int idx = threadIdx.x; idx < kReduceRows * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx - r * D;
      float kk = 0.f, vv = 0.f;
      if (r < rows) {  // the ragged edge is masked, never padded
        const size_t off = head_base + static_cast<size_t>(base + r) * row_stride + c;
        kk = phi(load_f32(k + off));
        vv = load_f32(v + off);
      }
      ks[r][c] = kk;
      vs[r][c] = vv;
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const float kr = ks[r][warp + kWarps * i];
#pragma unroll
        for (int j = 0; j < CC; ++j) acc[i][j] = fmaf(kr, vs[r][lane + 32 * j], acc[i][j]);
      }
    }
    if (threadIdx.x < D)
      for (int r = 0; r < rows; ++r) ksum += ks[r][threadIdx.x];
    __syncthreads();
  }

  float* out = part + (static_cast<size_t>(bh) * S + s) * D * (D + 1);
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int j = 0; j < CC; ++j) out[(warp + kWarps * i) * (D + 1) + lane + 32 * j] = acc[i][j];
  if (threadIdx.x < D) out[threadIdx.x * (D + 1) + D] = ksum;
}

// Kernel B. Shared memory: kv [D x (D+1)] (ksum in the last column), phi(q)
// tile [TQ x (D+1)] (padded rows keep the per-row normaliser free of bank
// conflicts), normaliser [TQ].
template <typename T, int D, int TQ>
__global__ void __launch_bounds__(kThreads)
apply_kv(const T* __restrict__ q, const float* __restrict__ part, T* __restrict__ out,
         int N, int H, int S, float eps) {
  constexpr int RR = TQ / kWarps;
  constexpr int CC = D / 32;
  constexpr int KV = D * (D + 1);
  extern __shared__ float smem[];
  float* kv = smem;
  float* qs = kv + KV;
  float* den = qs + TQ * (D + 1);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n0 = blockIdx.y * TQ;
  const int rows = min(TQ, N - n0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head_base = (static_cast<size_t>(b) * N * H + h) * D;

  const float* pb = part + static_cast<size_t>(bh) * S * KV;
  for (int idx = threadIdx.x; idx < KV; idx += kThreads) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) a += pb[static_cast<size_t>(s) * KV + idx];
    kv[idx] = a;
  }
  for (int idx = threadIdx.x; idx < TQ * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    qs[r * (D + 1) + c] =
        r < rows ? phi(load_f32(q + head_base + static_cast<size_t>(n0 + r) * row_stride + c)) : 0.f;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < TQ; r += kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < D; ++i) a = fmaf(qs[r * (D + 1) + i], kv[i * (D + 1) + D], a);
    den[r] = a + eps;
  }
  __syncthreads();

  float acc[RR][CC];
#pragma unroll
  for (int r = 0; r < RR; ++r)
#pragma unroll
    for (int j = 0; j < CC; ++j) acc[r][j] = 0.f;
#pragma unroll 4
  for (int i = 0; i < D; ++i) {
    float kr[CC];
#pragma unroll
    for (int j = 0; j < CC; ++j) kr[j] = kv[i * (D + 1) + lane + 32 * j];
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const float qv = qs[(warp + kWarps * r) * (D + 1) + i];
#pragma unroll
      for (int j = 0; j < CC; ++j) acc[r][j] = fmaf(qv, kr[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int row = warp + kWarps * r;
    if (row < rows) {
      T* o = out + head_base + static_cast<size_t>(n0 + row) * row_stride;
#pragma unroll
      for (int j = 0; j < CC; ++j) store_from_f32(o + lane + 32 * j, acc[r][j] / den[row]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* scratch,
                   int B, int N, int H, int S, int chunk, float eps, cudaStream_t stream) {
  constexpr int TQ = D >= 128 ? 32 : 64;
  reduce_kv<T, D><<<dim3(B * H, S), kThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<float*>(scratch), N, H, S,
      chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem = static_cast<int>(sizeof(float) * (D * (D + 1) + TQ * (D + 1) + TQ));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(apply_kv<T, D, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  apply_kv<T, D, TQ><<<dim3(B * H, (N + TQ - 1) / TQ), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(scratch), static_cast<T*>(out), N, H, S,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, void* scratch,
                     int B, int N, int H, int D, int S, int chunk, float eps, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || S <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, scratch, B, N, H, S, chunk, eps, st);
    case 64: return launch<T, 64>(q, k, v, out, scratch, B, N, H, S, chunk, eps, st);
    case 128: return launch<T, 128>(q, k, v, out, scratch, B, N, H, S, chunk, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

cudaError_t linear_attention_f32(const void* q, const void* k, const void* v, void* out,
                                 void* scratch, int B, int N, int H, int D, int S, int chunk,
                                 float eps, void* stream) {
  return dispatch<float>(q, k, v, out, scratch, B, N, H, D, S, chunk, eps, stream);
}

cudaError_t linear_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                  void* scratch, int B, int N, int H, int D, int S, int chunk,
                                  float eps, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, scratch, B, N, H, D, S, chunk, eps, stream);
}

const char* linear_attention_error_string(cudaError_t err) { return cudaGetErrorString(err); }

}  // extern "C"
