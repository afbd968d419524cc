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
//
// The backward (linear_attention_bwd_*) replaces the closed-form VJP of
// `linear_attention_pallas_trainable` (`_trainable_bwd`,
// cv_diffusion_tpu/ops/pallas_attention.py:202-236), which the JAX package
// runs as XLA einsums after the Pallas forward. For g = dL/dout it recomputes
// everything from q, k, v in f32 (nothing is kept from the forward):
//
//   kv = sum_n phi(k)^T v, ksum = sum_n phi(k), den = phi(q).ksum + eps,
//   num = phi(q) kv, d_num = g / den, d_den = -sum_e g num / den^2,
//   dq = (d_num kv^T + d_den ksum) * phi'(q),
//   d_kv = sum_n phi(q)^T d_num, d_ksum = sum_n phi(q) d_den,
//   dk = (v d_kv^T + d_ksum) * phi'(k), dv = phi(k) d_kv,
//
// with phi'(x) = 1 for x > 0, else e^x; since phi(x) = e^x there, phi'(x) =
// min(phi(x), 1), which never overflows for large x. It is bound by bytes as
// the forward is (q, k, v, g read, dq, dk, dv written: 7 tensors against
// ~12 N H D^2 FLOP), in five launches, all in the forward's shape and
// without atomics, so reruns are bit-identical:
//
//   A  (reduce):  the forward's kernel A: partial kv, ksum per chunk of N.
//   C  (combine): grid (B*H, ...). Sums the S partials once, in a fixed
//     order, into kv [B, H, D, D+1] (the forward's apply re-sums them in
//     every block instead).
//   Q  (dq):      grid (B*H, S), the reduce's chunks of N. Per token of its
//     chunk: num and den (d_den needs num, which the forward does not keep),
//     d_num, d_den and dq; and partial d_kv, d_ksum over the chunk, written
//     over A's partials.
//   C  again:     d_kv, d_ksum [B, H, D, D+1].
//   K  (dk, dv):  grid (B*H, N tiles). Per token: dk and dv.
//
// Padded rows (N not a multiple of a tile or chunk) are masked: their phi(q)
// and g are zero, so they add nothing to any sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceRows = 32;  // rows of K/V staged in shared memory at a time
constexpr int kBwdRows = 32;     // backward: rows of Q/G staged at a time

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

// Kernel C. dst[bh][i] = sum_s part[bh][s][i], s in order.
__global__ void __launch_bounds__(kThreads)
combine_partials(const float* __restrict__ part, float* __restrict__ dst, int S, int KV) {
  const int bh = blockIdx.x;
  const float* src = part + static_cast<size_t>(bh) * S * KV;
  for (int i = blockIdx.y * kThreads + threadIdx.x; i < KV; i += gridDim.y * kThreads) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) a += src[static_cast<size_t>(s) * KV + i];
    dst[static_cast<size_t>(bh) * KV + i] = a;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Kernel Q. Shared memory: kv [D x (D+1)] (ksum in the last column), phi(q)
// and g (then d_num) tiles [R x (D+1)], d_den [R]. Warp w owns the tile's
// rows w + 8*i for num, den and dq (lane l: columns l + 32*j), and d_kv rows
// w + 8*i (columns l + 32*j) for the chunk's partial.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_q(const T* __restrict__ q, const T* __restrict__ g, const float* __restrict__ kv_in,
      T* __restrict__ dq, float* __restrict__ part, int N, int H, int S, int chunk, float eps) {
  constexpr int R = kBwdRows;
  constexpr int RR = R / kWarps;
  constexpr int CC = D / 32;
  constexpr int DR = D / kWarps;
  constexpr int LD = D + 1;
  constexpr int KV = D * LD;
  extern __shared__ float smem[];
  float* kv = smem;
  float* qs = kv + KV;
  float* gs = qs + R * LD;
  float* dd = gs + R * LD;

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

  for (int idx = threadIdx.x; idx < KV; idx += kThreads)
    kv[idx] = kv_in[static_cast<size_t>(bh) * KV + idx];
  float acc[DR][CC];
#pragma unroll
  for (int i = 0; i < DR; ++i)
#pragma unroll
    for (int j = 0; j < CC; ++j) acc[i][j] = 0.f;
  float dks = 0.f;  // threads t < D own d_ksum[t]

  for (int base = n_begin; base < n_end; base += R) {
    const int rows = min(R, n_end - base);
    __syncthreads();  // kv is staged; the previous tile is done with qs, gs, dd
    for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx - r * D;
      float qq = 0.f, gg = 0.f;
      if (r < rows) {
        const size_t off = head_base + static_cast<size_t>(base + r) * row_stride + c;
        qq = phi(load_f32(q + off));
        gg = load_f32(g + off);
      }
      qs[r * LD + c] = qq;
      gs[r * LD + c] = gg;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const int row = warp + kWarps * i;
      const float* qr = qs + row * LD;
      float num[CC];
#pragma unroll
      for (int j = 0; j < CC; ++j) num[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float qv = qr[d];
#pragma unroll
        for (int j = 0; j < CC; ++j) num[j] = fmaf(qv, kv[d * LD + lane + 32 * j], num[j]);
      }
      float dpart = 0.f, spart = 0.f;
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        const int c = lane + 32 * j;
        dpart = fmaf(qr[c], kv[c * LD + D], dpart);
        spart = fmaf(gs[row * LD + c], num[j], spart);
      }
      const float den = warp_sum(dpart) + eps;  // eps before the square
      const float sg = warp_sum(spart);
      const bool live = row < rows;
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        float* gp = gs + row * LD + lane + 32 * j;
        *gp = live ? *gp / den : 0.f;  // d_num
      }
      if (lane == 0) dd[row] = live ? -sg / (den * den) : 0.f;
    }
    __syncthreads();

    // dq = (d_num kv^T + d_den ksum) * phi'(q)
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const int row = warp + kWarps * i;
      if (row >= rows) continue;
      const float* gr = gs + row * LD;
      float a[CC];
#pragma unroll
      for (int j = 0; j < CC; ++j) a[j] = 0.f;
      for (int e = 0; e < D; ++e) {
        const float gv = gr[e];
#pragma unroll
        for (int j = 0; j < CC; ++j) a[j] = fmaf(gv, kv[(lane + 32 * j) * LD + e], a[j]);
      }
      T* o = dq + head_base + static_cast<size_t>(base + row) * row_stride;
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        const int c = lane + 32 * j;
        const float dphi = fmaf(dd[row], kv[c * LD + D], a[j]);
        store_from_f32(o + c, dphi * fminf(qs[row * LD + c], 1.f));
      }
    }

    // this chunk's d_kv += phi(q)^T d_num, d_ksum += phi(q)^T d_den
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int i = 0; i < DR; ++i) {
        const float qv = qs[r * LD + warp + kWarps * i];
#pragma unroll
        for (int j = 0; j < CC; ++j) acc[i][j] = fmaf(qv, gs[r * LD + lane + 32 * j], acc[i][j]);
      }
    }
    if (threadIdx.x < D)
      for (int r = 0; r < rows; ++r) dks = fmaf(qs[r * LD + threadIdx.x], dd[r], dks);
  }

  float* out = part + (static_cast<size_t>(bh) * S + s) * KV;
#pragma unroll
  for (int i = 0; i < DR; ++i)
#pragma unroll
    for (int j = 0; j < CC; ++j) out[(warp + kWarps * i) * LD + lane + 32 * j] = acc[i][j];
  if (threadIdx.x < D) out[threadIdx.x * LD + D] = dks;
}

// Kernel K. Shared memory: d_kv [D x (D+1)] (d_ksum in the last column),
// phi(k) and v tiles [TQ x (D+1)]. Warp w owns rows w + 8*r, lane l columns
// l + 32*j of dk and dv.
template <typename T, int D, int TQ>
__global__ void __launch_bounds__(kThreads)
bwd_kv(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ dkv_in,
       T* __restrict__ dk, T* __restrict__ dv, int N, int H) {
  constexpr int RR = TQ / kWarps;
  constexpr int CC = D / 32;
  constexpr int LD = D + 1;
  constexpr int KV = D * LD;
  extern __shared__ float smem[];
  float* dkv = smem;
  float* ks = dkv + KV;
  float* vs = ks + TQ * LD;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n0 = blockIdx.y * TQ;
  const int rows = min(TQ, N - n0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head_base = (static_cast<size_t>(b) * N * H + h) * D;

  for (int idx = threadIdx.x; idx < KV; idx += kThreads)
    dkv[idx] = dkv_in[static_cast<size_t>(bh) * KV + idx];
  for (int idx = threadIdx.x; idx < TQ * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    float kk = 0.f, vv = 0.f;
    if (r < rows) {
      const size_t off = head_base + static_cast<size_t>(n0 + r) * row_stride + c;
      kk = phi(load_f32(k + off));
      vv = load_f32(v + off);
    }
    ks[r * LD + c] = kk;
    vs[r * LD + c] = vv;
  }
  __syncthreads();

  float ak[RR][CC], av[RR][CC];
#pragma unroll
  for (int r = 0; r < RR; ++r)
#pragma unroll
    for (int j = 0; j < CC; ++j) ak[r][j] = av[r][j] = 0.f;
#pragma unroll 4
  for (int i = 0; i < D; ++i) {
    float wk[CC], wv[CC];
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      wk[j] = dkv[(lane + 32 * j) * LD + i];  // d_kv[c][i]: v . d_kv^T
      wv[j] = dkv[i * LD + lane + 32 * j];    // d_kv[i][c]: phi(k) . d_kv
    }
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const int row = warp + kWarps * r;
      const float vr = vs[row * LD + i];
      const float kr = ks[row * LD + i];
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        ak[r][j] = fmaf(vr, wk[j], ak[r][j]);
        av[r][j] = fmaf(kr, wv[j], av[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int row = warp + kWarps * r;
    if (row >= rows) continue;
    const size_t at = head_base + static_cast<size_t>(n0 + row) * row_stride;
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      const int c = lane + 32 * j;
      const float dphi = ak[r][j] + dkv[c * LD + D];
      store_from_f32(dk + at + c, dphi * fminf(ks[row * LD + c], 1.f));
      store_from_f32(dv + at + c, av[r][j]);
    }
  }
}

// Dynamic shared memory above 48 KB has to be allowed per kernel; done once
// for the largest request, so a later launch (or a CUDA graph capture) calls
// no cudaFuncSetAttribute.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static int allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                       void* dk, void* dv, void* scratch, int B, int N, int H, int S, int chunk,
                       float eps, cudaStream_t stream) {
  constexpr int TQ = D >= 128 ? 32 : 64;
  constexpr int KV = D * (D + 1);
  float* part = static_cast<float*>(scratch);                       // [B*H, S, KV]
  float* kv = part + static_cast<size_t>(B) * H * S * KV;            // [B*H, KV]
  float* dkv = kv + static_cast<size_t>(B) * H * KV;                 // [B*H, KV]
  const dim3 combine_grid(B * H, (KV + kThreads - 1) / kThreads);

  reduce_kv<T, D><<<dim3(B * H, S), kThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), part, N, H, S, chunk);
  combine_partials<<<combine_grid, kThreads, 0, stream>>>(part, kv, S, KV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = static_cast<int>(sizeof(float) * (KV + 2 * kBwdRows * (D + 1) + kBwdRows));
  err = allow_smem<bwd_q<T, D>>(smem_q);
  if (err != cudaSuccess) return err;
  bwd_q<T, D><<<dim3(B * H, S), kThreads, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(g), kv, static_cast<T*>(dq), part, N, H, S,
      chunk, eps);
  combine_partials<<<combine_grid, kThreads, 0, stream>>>(part, dkv, S, KV);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_k = static_cast<int>(sizeof(float) * (KV + 2 * TQ * (D + 1)));
  err = allow_smem<bwd_kv<T, D, TQ>>(smem_k);
  if (err != cudaSuccess) return err;
  bwd_kv<T, D, TQ><<<dim3(B * H, (N + TQ - 1) / TQ), kThreads, smem_k, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), dkv, static_cast<T*>(dk),
      static_cast<T*>(dv), N, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
                         void* dk, void* dv, void* scratch, int B, int N, int H, int D, int S,
                         int chunk, float eps, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || S <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bwd<T, 32>(q, k, v, g, dq, dk, dv, scratch, B, N, H, S, chunk, eps, st);
    case 64: return launch_bwd<T, 64>(q, k, v, g, dq, dk, dv, scratch, B, N, H, S, chunk, eps, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, g, dq, dk, dv, scratch, B, N, H, S, chunk, eps, st);
    default: return cudaErrorInvalidValue;
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

cudaError_t linear_attention_bwd_f32(const void* q, const void* k, const void* v, const void* g,
                                     void* dq, void* dk, void* dv, void* scratch, int B, int N,
                                     int H, int D, int S, int chunk, float eps, void* stream) {
  return dispatch_bwd<float>(q, k, v, g, dq, dk, dv, scratch, B, N, H, D, S, chunk, eps, stream);
}

cudaError_t linear_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* g,
                                      void* dq, void* dk, void* dv, void* scratch, int B, int N,
                                      int H, int D, int S, int chunk, float eps, void* stream) {
  return dispatch_bwd<__nv_bfloat16>(q, k, v, g, dq, dk, dv, scratch, B, N, H, D, S, chunk, eps,
                                     stream);
}

const char* linear_attention_error_string(cudaError_t err) { return cudaGetErrorString(err); }

}  // extern "C"
