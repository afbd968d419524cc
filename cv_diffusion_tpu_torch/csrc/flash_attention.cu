// Softmax attention by online softmax ("flash attention"), forward and
// backward, for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
//   out = softmax(q k^T * scale) v
//
// per batch element and head, on q, k, v, out laid out [B, N, H, D] (row
// stride H * D: the JAX package's token layout, read as it is).
//
// The three kernels replace JAX's stock Pallas TPU flash attention, which the
// JAX package reaches through `standard_attention_flash`
// (cv_diffusion_tpu/ops/attention.py:139) from `StandardAttentionBlock` with
// `use_pallas` (jax/experimental/pallas/ops/tpu/flash_attention.py in JAX
// 0.9.0):
//
//   flash_fwd_*      the forward `_flash_attention_impl` (:589, pallas_call
//                    :758), which also saves each row's max m and sum l;
//   flash_bwd_dkv_*  `_flash_attention_bwd_dkv` (:941, pallas_call :1121);
//   flash_bwd_dq_*   `_flash_attention_bwd_dq` (:1287, pallas_call :1456),
//                    without its `ds` output (it serves an attention bias,
//                    which the JAX package never passes).
//
// The TPU kernels walk the key blocks on a sequential grid axis and carry the
// running max, sum and accumulator from one grid step to the next in
// scratch; the dK/dV kernel walks the query blocks the same way. On a GPU
// the blocks of a grid run in parallel and in no order, so here that walk is
// a loop inside one block, and the carried state stays in registers.
//
// What bounds them on an H100. At the small UNet's mid_attn shape
// [B, 1024, 4, 32] in f32 the two products are 4 * B * H * N^2 * D = 0.537
// GFLOP an image (8.0 us at 67 TFLOP/s on the CUDA cores) against 2.1 MB of
// q, k, v and out (0.63 us at 3.35 TB/s): bound by operations, as attention
// is at any N above ~100 at D = 32. The backward does five such products
// (q k^T, dO v^T, P^T dO, dS^T q, dS k; the dQ kernel recomputes the first
// two), also bound by operations.
//
// The design, simple first. Every kernel is a grid of (N / 64 tiles) x H x B
// blocks of 256 threads; a tile is 64 rows. Operands are staged in shared
// memory as f32 (16-byte loads from device memory; rows past N are zeros),
// with a pitch of D + 1 floats so that the micro-tile reads below fall in
// distinct banks. A thread owns a 4 x 4 micro tile of each 64 x 64 score
// tile (rows 4 * rg + i, columns cg + 16 * j for its row group rg and column
// group cg, 16 of each) and a 4 x D/16 tile of each 64 x D accumulator
// (columns cg + 16 * j), both computed with FMAs on the CUDA cores; the 16
// threads of a row group are one half-warp, so a row's max and sum are
// butterfly shuffles within it (each lane ends with the same value).
//
//   forward (one block per query tile): q staged once; per key tile k and v
//     staged, the scores S = q k^T * scale (keys past N are -inf), the row
//     max m, P = exp(S - m_new) written to shared memory (rounded to bf16 in
//     the bf16 entry before P v, as the stock kernel's p.astype(v.dtype);
//     the row sum l is taken before that rounding), the accumulator
//     rescaled by exp(m_old - m_new) and P v added. At the end out = acc / l
//     and, when asked, the f32 log-sum-exp m + log(l) [B, H, N].
//   dK/dV (one block per key tile): k and v staged once; per query tile q,
//     dO, lse and di = sum(o * dO) (one row reduction outside the kernels,
//     as the stock VJP computes it in XLA) staged, P = exp(S - lse),
//     dP = dO v^T, dS = (dP - di) * P * scale, P and dS written to shared
//     memory (each rounded to bf16 in the bf16 entry), dV += P^T dO,
//     dK += dS^T q.
//   dQ (one block per query tile): q, dO, lse, di staged once; per key tile
//     P and dS again, dQ += dS k.
//
// No atomics and a fixed order of every sum, so reruns are bit-identical;
// no scratch in device memory: a launch writes only its outputs, so the
// forward captures into a CUDA graph. expf (not __expf) keeps the f32
// forward within 2e-5 of the plain version. The products on the tensor cores
// (wgmma from TMA-staged tiles) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;              // rows of a query or key tile
constexpr int kThreads = 256;          // 16 row groups x 16 column groups
constexpr int kGroups = 16;
constexpr int kRows = kTile / kGroups;  // rows of a thread's micro tile (4)
constexpr int kCols = kTile / kGroups;  // score columns of a thread (4)
constexpr int kSPitch = kTile + 1;      // floats a row of a staged score tile

template <int D>
__host__ __device__ constexpr int pitch() { return D + 1; }

template <int D>
__host__ __device__ constexpr int staged_floats() { return kTile * pitch<D>(); }

// Shared memory of each kernel, in floats.
template <int D>
constexpr int fwd_floats() { return 3 * staged_floats<D>() + kTile * kSPitch; }
template <int D>
constexpr int dkv_floats() { return 4 * staged_floats<D>() + 2 * kTile * kSPitch + 2 * kTile; }
template <int D>
constexpr int dq_floats() { return 4 * staged_floats<D>() + kTile * kSPitch + 2 * kTile; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and kept as f32: the stock kernel's cast before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// Max and sum over the 16 lanes of a half-warp (one row group).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < kGroups; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < kGroups; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ long long offset(int b, int n, int h, int N, int H, int D) {
  return ((static_cast<long long>(b) * N + n) * H + h) * D;
}

// Stage rows [row0, row0 + kTile) of head h of batch element b of x
// [B, N, H, D] in shared memory as f32 with pitch D + 1; rows past N are 0.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x, int b, int h,
                                      int row0, int N, int H) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte vector
  constexpr int V = D / E;                              // vectors a row
  for (int i = threadIdx.x; i < kTile * V; i += kThreads) {
    const int r = i / V, c = (i % V) * E;
    const int n = row0 + r;
    float* out = dst + r * pitch<D>() + c;
    if (n < N) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + offset(b, n, h, N, H, D) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < E; ++j) out[j] = to_float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) out[j] = 0.0f;
    }
  }
}

// The row statistics of rows [row0, row0 + kTile): lse (+inf past N, so that
// P = exp(S - lse) is 0 there) and di (0 past N), from [B, H, N] f32.
__device__ __forceinline__ void stage_rows(float* slse, float* sdi, const float* __restrict__ lse,
                                           const float* __restrict__ di, int b, int h, int row0,
                                           int N, int H) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int n = row0 + i;
    const long long at = (static_cast<long long>(b) * H + h) * N + n;
    slse[i] = n < N ? lse[at] : INFINITY;
    sdi[i] = n < N ? di[at] : 0.0f;
  }
}

// s[i][j] = a[4 rg + i] . b[cg + 16 j] over D, both staged with pitch D + 1.
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[kRows][kCols], const float* a, const float* b,
                                         int rg, int cg) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[(kRows * rg + i) * pitch<D>() + d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = b[(cg + kGroups * j) * pitch<D>() + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][c] += sum_j w(4 rg + i, j) x[j][cg + 16 c] over the kTile staged rows
// of x, with w(r, j) = p[r][j], or p[j][r] when Transposed (p a staged score
// tile, pitch kSPitch).
template <int D, bool Transposed>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][D / kGroups], const float* p,
                                           const float* x, int rg, int cg) {
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float w[kRows], xv[D / kGroups];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      w[i] = Transposed ? p[j * kSPitch + kRows * rg + i] : p[(kRows * rg + i) * kSPitch + j];
#pragma unroll
    for (int c = 0; c < D / kGroups; ++c) xv[c] = x[j * pitch<D>() + cg + kGroups * c];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < D / kGroups; ++c) acc[i][c] = fmaf(w[i], xv[c], acc[i][c]);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[kRows][D / kGroups]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < D / kGroups; ++c) acc[i][c] = 0.0f;
}

// Rows [row0 + 4 rg, row0 + 4 rg + 4) of y, the thread's columns, from acc.
template <typename T, int D>
__device__ __forceinline__ void store(T* __restrict__ y, const float (&acc)[kRows][D / kGroups],
                                      int b, int h, int row0, int N, int H, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int n = row0 + kRows * rg + i;
    if (n >= N) continue;
    T* row = y + offset(b, n, h, N, H, D);
#pragma unroll
    for (int c = 0; c < D / kGroups; ++c) row[cg + kGroups * c] = from_float<T>(acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse, int N, int H, float scale) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + staged_floats<D>();
  float* sv = sk + staged_floats<D>();
  float* sp = sv + staged_floats<D>();
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int rg = threadIdx.x / kGroups, cg = threadIdx.x % kGroups;

  stage<T, D>(sq, q, b, h, q0, N, H);
  float m[kRows], l[kRows], acc[kRows][D / kGroups];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  zero<D>(acc);

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // every thread is done with the last tile's k, v and P
    stage<T, D>(sk, k, b, h, k0, N, H);
    stage<T, D>(sv, v, b, h, k0, N, H);
    __syncthreads();
    float s[kRows][kCols];
    dot_tile<D>(s, sq, sk, rg, cg);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = k0 + cg + kGroups * j < N ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));  // finite: a tile has a key
      const float alpha = expf(m[i] - m_new);        // 0 on the first tile
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sp[(kRows * rg + i) * kSPitch + cg + kGroups * j] = round_to<T>(p);
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / kGroups; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    accumulate<D, false>(acc, sp, sv, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < D / kGroups; ++c) acc[i][c] /= l[i];
    const int n = q0 + kRows * rg + i;
    if (lse != nullptr && cg == 0 && n < N)
      lse[(static_cast<long long>(b) * H + h) * N + n] = m[i] + logf(l[i]);
  }
  store<T, D>(out, acc, b, h, q0, N, H, rg, cg);
}

// P = exp(S - lse) (0 for keys past N; rows past N have lse = +inf) and
// dS = (dP - di) * P * scale, each rounded to T, into the staged tiles sp
// (when given) and sds at the thread's micro tile.
template <typename T>
__device__ __forceinline__ void probabilities(float* sp, float* sds, const float (&s)[kRows][kCols],
                                              const float (&dp)[kRows][kCols], const float* slse,
                                              const float* sdi, int k0, int N, float scale, int rg,
                                              int cg) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = kRows * rg + i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = cg + kGroups * j;
      const float p = k0 + c < N ? expf(s[i][j] * scale - slse[r]) : 0.0f;
      const float ds = (dp[i][j] - sdi[r]) * p * scale;
      if (sp != nullptr) sp[r * kSPitch + c] = round_to<T>(p);
      sds[r * kSPitch + c] = round_to<T>(ds);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         T* __restrict__ dk, T* __restrict__ dv, int N, int H, float scale) {
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + staged_floats<D>();
  float* sq = sv + staged_floats<D>();
  float* sdo = sq + staged_floats<D>();
  float* sp = sdo + staged_floats<D>();
  float* sds = sp + kTile * kSPitch;
  float* slse = sds + kTile * kSPitch;
  float* sdi = slse + kTile;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int rg = threadIdx.x / kGroups, cg = threadIdx.x % kGroups;

  stage<T, D>(sk, k, b, h, k0, N, H);
  stage<T, D>(sv, v, b, h, k0, N, H);
  float adk[kRows][D / kGroups], adv[kRows][D / kGroups];
  zero<D>(adk);
  zero<D>(adv);

  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();  // every thread is done with the last tile's q, dO, P and dS
    stage<T, D>(sq, q, b, h, q0, N, H);
    stage<T, D>(sdo, dout, b, h, q0, N, H);
    stage_rows(slse, sdi, lse, di, b, h, q0, N, H);
    __syncthreads();
    // rows: the tile's queries; columns: this block's keys
    float s[kRows][kCols], dp[kRows][kCols];
    dot_tile<D>(s, sq, sk, rg, cg);
    dot_tile<D>(dp, sdo, sv, rg, cg);
    probabilities<T>(sp, sds, s, dp, slse, sdi, k0, N, scale, rg, cg);
    __syncthreads();
    accumulate<D, true>(adv, sp, sdo, rg, cg);  // dV[key] += sum_q P[q][key] dO[q]
    accumulate<D, true>(adk, sds, sq, rg, cg);  // dK[key] += sum_q dS[q][key] q[q]
  }
  store<T, D>(dk, adk, b, h, k0, N, H, rg, cg);
  store<T, D>(dv, adv, b, h, k0, N, H, rg, cg);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        T* __restrict__ dq, int N, int H, float scale) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + staged_floats<D>();
  float* sk = sdo + staged_floats<D>();
  float* sv = sk + staged_floats<D>();
  float* sds = sv + staged_floats<D>();
  float* slse = sds + kTile * kSPitch;
  float* sdi = slse + kTile;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int rg = threadIdx.x / kGroups, cg = threadIdx.x % kGroups;

  stage<T, D>(sq, q, b, h, q0, N, H);
  stage<T, D>(sdo, dout, b, h, q0, N, H);
  stage_rows(slse, sdi, lse, di, b, h, q0, N, H);
  float adq[kRows][D / kGroups];
  zero<D>(adq);

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // every thread is done with the last tile's k, v and dS
    stage<T, D>(sk, k, b, h, k0, N, H);
    stage<T, D>(sv, v, b, h, k0, N, H);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    dot_tile<D>(s, sq, sk, rg, cg);
    dot_tile<D>(dp, sdo, sv, rg, cg);
    probabilities<T>(nullptr, sds, s, dp, slse, sdi, k0, N, scale, rg, cg);
    __syncthreads();
    accumulate<D, false>(adq, sds, sk, rg, cg);  // dQ[q] += sum_key dS[q][key] k[key]
  }
  store<T, D>(dq, adq, b, h, q0, N, H, rg, cg);
}

// Shared memory above 48 KB must be allowed per kernel and device before the
// first launch (cudaFuncSetAttribute); done once a kernel and device.
constexpr int kMaxDevices = 64;
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

dim3 grid(int B, int N, int H) { return dim3((N + kTile - 1) / kTile, H, B); }

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

template <typename T, int D>
cudaError_t forward_d(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                      int N, int H, float scale, cudaStream_t stream) {
  constexpr int smem = 4 * fwd_floats<D>();
  const cudaError_t err = allow_smem<flash_fwd_kernel<T, D>>(smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<grid(B, N, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, N, H, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkv_d(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* di, void* dk, void* dv, int B, int N, int H,
                  float scale, cudaStream_t stream) {
  constexpr int smem = 4 * dkv_floats<D>();
  const cudaError_t err = allow_smem<flash_bwd_dkv_kernel<T, D>>(smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D><<<grid(B, N, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dk), static_cast<T*>(dv), N, H,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dq_d(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* di, void* dq, int B, int N, int H, float scale,
                 cudaStream_t stream) {
  constexpr int smem = 4 * dq_floats<D>();
  const cudaError_t err = allow_smem<flash_bwd_dq_kernel<T, D>>(smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<grid(B, N, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dq), N, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                    int N, int H, int D, float scale, void* stream) {
  if (static_cast<long long>(B) * N * H == 0) return cudaSuccess;
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out))
    return cudaErrorMisalignedAddress;
  auto* l = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return forward_d<T, 32>(q, k, v, out, l, B, N, H, scale, st);
    case 64: return forward_d<T, 64>(q, k, v, out, l, B, N, H, scale, st);
    case 128: return forward_d<T, 128>(q, k, v, out, l, B, N, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* di, void* dk, void* dv, int B, int N, int H,
                         int D, float scale, void* stream) {
  if (static_cast<long long>(B) * N * H == 0) return cudaSuccess;
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout)) {
    return cudaErrorMisalignedAddress;
  }
  auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<const float*>(di);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dkv_d<T, 32>(q, k, v, dout, l, d, dk, dv, B, N, H, scale, st);
    case 64: return dkv_d<T, 64>(q, k, v, dout, l, d, dk, dv, B, N, H, scale, st);
    case 128: return dkv_d<T, 128>(q, k, v, dout, l, d, dk, dv, B, N, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t backward_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* di, void* dq, int B, int N, int H, int D,
                        float scale, void* stream) {
  if (static_cast<long long>(B) * N * H == 0) return cudaSuccess;
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout)) {
    return cudaErrorMisalignedAddress;
  }
  auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<const float*>(di);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dq_d<T, 32>(q, k, v, dout, l, d, dq, B, N, H, scale, st);
    case 64: return dq_d<T, 64>(q, k, v, dout, l, d, dq, B, N, H, scale, st);
    case 128: return dq_d<T, 128>(q, k, v, dout, l, d, dq, B, N, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, out [B, N, H, D]; lse [B, H, N] f32, or null when no gradient is
// wanted.
cudaError_t flash_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                          int B, int N, int H, int D, float scale, void* stream) {
  return forward<float>(q, k, v, out, lse, B, N, H, D, scale, stream);
}

cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                           int B, int N, int H, int D, float scale, void* stream) {
  return forward<__nv_bfloat16>(q, k, v, out, lse, B, N, H, D, scale, stream);
}

// dout, dk, dv [B, N, H, D]; lse and di = sum(out * dout, -1) [B, H, N] f32.
cudaError_t flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* di, void* dk, void* dv, int B, int N,
                              int H, int D, float scale, void* stream) {
  return backward_dkv<float>(q, k, v, dout, lse, di, dk, dv, B, N, H, D, scale, stream);
}

cudaError_t flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, void* dk, void* dv, int B, int N,
                               int H, int D, float scale, void* stream) {
  return backward_dkv<__nv_bfloat16>(q, k, v, dout, lse, di, dk, dv, B, N, H, D, scale, stream);
}

cudaError_t flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* di, void* dq, int B, int N, int H,
                             int D, float scale, void* stream) {
  return backward_dq<float>(q, k, v, dout, lse, di, dq, B, N, H, D, scale, stream);
}

cudaError_t flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* di, void* dq, int B, int N, int H,
                              int D, float scale, void* stream) {
  return backward_dq<__nv_bfloat16>(q, k, v, dout, lse, di, dq, B, N, H, D, scale, stream);
}

// Dynamic shared memory of one block in bytes: kernel 0 the forward, 1 dK/dV,
// 2 dQ; -1 for a head dim without an instance.
int flash_attention_smem_bytes(int D, int kernel) {
  switch (D) {
    case 32: return 4 * (kernel == 0 ? fwd_floats<32>() : kernel == 1 ? dkv_floats<32>() : dq_floats<32>());
    case 64: return 4 * (kernel == 0 ? fwd_floats<64>() : kernel == 1 ? dkv_floats<64>() : dq_floats<64>());
    case 128: return 4 * (kernel == 0 ? fwd_floats<128>() : kernel == 1 ? dkv_floats<128>() : dq_floats<128>());
    default: return -1;
  }
}

// Rows of a tile (query or key), the same in all three kernels.
int flash_attention_tile_rows() { return kTile; }

const char* flash_attention_error_string(cudaError_t err) { return cudaGetErrorString(err); }

}  // extern "C"
