// Fused stride-1 inverted residual block (IRB) forward for NVIDIA Hopper
// (sm_90a), hand-written CUDA C++.
//
//   h2  = act(a2 * ((act(a1 * x + b1)) . W_exp) + b2)      [Chid channels]
//   h3  = dw3x3(h2)  (zero rows and columns outside the image)
//   out = (h3 * gate) . W_proj + (x or x . W_skip)          [Cout channels]
//   gate = sigmoid(fc2(act(fc1(mean_p h3))))                 (SE; 1 without)
//
// on x and out laid out NCHW [B, C, H, W]; act is ReLU6 or SiLU. In v2 (the
// fused_irb_f32/_bf16 entry points) GN1 and GN2+FiLM arrive folded into
// per-(batch, channel) affines (a1, b1) [B, Cin] and (a2, b2) [B, Chid],
// computed outside (ops/fused_irb.py), as the JAX package computes them in
// XLA outside its kernel; v1 (below) computes them itself. The kernel reads x and
// applies act(a1 * x + b1) itself, as the TPU kernel does (pallas_irb.py:
// 440-441); x-hat exists in device memory only inside the fold, for its Gram.
// Every weight is read in the layout of the port's module parameters: W_exp
// [Chid, Cin], W_proj [Cout, Chid], W_skip [Cout, Cin], so no call copies one.
//
// Replaces the TPU kernel `fused_irb_v2` (`_kernel_v2`,
// cv_diffusion_tpu/ops/pallas_irb.py:607). That kernel keeps a whole image
// of x in VMEM and walks a sequential (B, 2 phases, row tiles) grid,
// carrying the SE edge sums from one grid step to the next in scratch. Here
// blocks run in parallel and in no order, so the phases are launches:
//
//   pool (SE only): grid (pixel groups, Chid/32, B). A block recomputes h2
//     for 16x16-pixel tiles of its group and 32 hidden channels and writes,
//     per channel, h2's total and its sums over the first and last row, the
//     first and last column and the four corners to scratch [B, groups, 9,
//     Chid]. The mean of h3 follows exactly from those nine sums (the v2
//     identity, pallas_irb.py:449-516), so the pool pass needs no halo and
//     no depthwise.
//   gate (SE only): three small launches. Sum the partials in a fixed order
//     and form the mean of h3 [B, Chid]; fc1 -> act [B, Csq]; fc2 -> sigmoid
//     into gate [B, Chid]. Each spreads its weights over many blocks.
//   out: grid (tiles, hidden groups x output blocks, B). A block owns a
//     TH x TW output tile of up to 256 output channels (wider outputs, 384
//     to 512 in the base and large UNets, take several blocks, each of which
//     recomputes the tile's h2: simple, and right for any Cout; the expand
//     is then done once per 256 output channels) and loops over chunks of
//     CC hidden channels: h2 on the tile plus a
//     one-pixel halo (recomputed; zero outside the image) into shared memory,
//     the nine-tap depthwise times the gate into shared memory, and h3 . W_proj
//     accumulated into the output tile held in registers (8 output channels
//     by MP pixels a thread). Hidden width reaches 2048 (small) and 4096
//     (large), so h2 never fits
//     whole: the chunking over Chid is what keeps it out of device memory.
//     The first hidden group adds the residual. With one group the block
//     writes out; with several (small images, where tiles alone cannot fill
//     132 SMs) each writes an f32 partial, and
//   combine: sums the partials in a fixed order into out.
//
// No atomics anywhere, so reruns are bit-identical.
//
// The v1 entry points (fused_irb_v1_*) replace the TPU kernel `fused_irb`
// (`_kernel`, cv_diffusion_tpu/ops/pallas_irb.py:241), which computes the
// same function but takes both GroupNorms' statistics itself, GN2's from h1
// = act(GN1 x) . W_exp: over a sequential (B, 4 phases, row tiles) grid it
// sums x and x^2 per GN1 group (phase 0), then h1 and h1^2 per GN2 group
// (phase 1), one pass, var = max(E[v^2] - E[v]^2, 0), then pools h3 and
// writes out. Here those phases are launches, and the sums are fixed-order
// partials instead of a carried accumulator:
//
//   gn1_stats: grid (pixel groups, B). Warp w sums x and x^2 of channels w,
//     w + 8, ... over the block's pixels: scratch [B, groups, 2, Cin].
//   gn_finalize: grid (norm groups, B). Sums one norm's per-channel partials
//     in a fixed order and writes its per-(batch, channel) affine (a, b)
//     [B, C], GN2's with gamma, beta and FiLM's (1 + fs), fb folded in.
//   gn2_stats: the pool pass's grid. A block recomputes h1 (x-hat from the
//     GN1 affine just written, times W_exp; never in device memory) on 16 x
//     16-pixel tiles and 32 hidden channels, and writes per-channel partial
//     sums of h1 and h1^2: scratch [B, pool groups, 2, Chid]. GN2's groups
//     (4 to 128 channels) may straddle the blocks' 32-channel chunks or hold
//     several; the finalize pass sums whole groups from the channels.
//   gn_finalize for GN2, then the passes above (pool, gate, out, combine),
//     driven with the affines on the device.
//
// No tensor op runs between v1's input and its output. The cost against v2
// is one more expand pass over every pixel (gn2_stats: 2*Cin*Chid FLOP a
// pixel, about a third of the block's products) in place of the fold's ~40
// tensor ops around a Gram product. v1's bf16 entry reads x and writes out
// in bf16 but, as the TPU kernel (every operand cast to f32, only the output
// rounded), gives its products f32 operands: the operand rounding of v2's
// bf16 path is a compile-time switch (R below), off for v1.
//
// What bounds it on an H100: the three products per pixel are about
// 2*Chid*(Cin + 9/2 + Cout) FLOP against (Cin + Cout)*4 bytes of x and out,
// 68 to 1,000 FLOP per byte at the serving shapes, so it is bound by
// float32 operations on the CUDA cores (67 TFLOP/s) once the hidden tensor
// stays on chip. x and out stay NCHW (the port's layout): no transposes.
// The f32 path is IEEE float32 throughout (no TF32, no tensor cores); v2's
// bf16 path reads and writes bf16 and rounds the operands of the three
// products to bf16, with f32 accumulation, as the TPU kernel's bf16 dots do
// (pallas_irb.py:426-427). v1 does the same function plus one expand for
// GN2's statistics, so the same float32 operations bound it.
// This version is simple: the expand is recomputed for the halo and again in
// the pool pass, and the products run from shared memory on the CUDA cores.
// wgmma, TMA and 3xTF32 are later work.
//
// The entry points launch on the caller's stream and return the cudaError_t
// of the launches; they allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KC = 32;         // input channels of x staged per step (skip)
constexpr int KX = 16;         // input channels of x per stage (expand; two in flight)
constexpr int KP = 32;         // hidden channels of W_proj staged per step
constexpr int kPoolTile = 16;  // pool pass: 16 x 16 pixels ...
constexpr int kPoolCC = 32;    // ... by 32 hidden channels per step

// Output tile (TH x TW pixels) and hidden chunk (CC) for outputs padded to
// CO_PAD channels (above 256: blocks of 256); cv_diffusion_tpu_torch/ops/fused_irb_kernel.py holds the
// same table and passes it in, and the launcher checks that they agree.
template <int CO_PAD> struct OutCfg;
template <> struct OutCfg<32> { static constexpr int TH = 16, TW = 16, CC = 24; };
template <> struct OutCfg<64> { static constexpr int TH = 16, TW = 16, CC = 24; };
template <> struct OutCfg<128> { static constexpr int TH = 8, TW = 16, CC = 40; };
template <> struct OutCfg<256> { static constexpr int TH = 8, TW = 8, CC = 80; };

struct Irb {
  const void* x;       // [B, Cin, H, W], T
  const float* a1;
  const float* b1;     // [B, Cin]: GN1 folded
  const float* a2;
  const float* b2;     // [B, Chid]: GN2 + FiLM folded
  const float* wexp;   // [Chid, Cin]
  const float* wdw;    // [Chid, 9]
  const float* wproj;  // [Cout, Chid]
  const float* wskip;  // [Cout, Cin], or null: identity residual
  const float* se_w1;  // [Csq, Chid]
  const float* se_b1;  // [Csq]
  const float* se_w2;  // [Chid, Csq]
  const float* se_b2;  // [Chid]
  void* out;           // [B, Cout, H, W], T
  float* pool;         // [B, pool_groups, 9, Chid]
  float* pooled;       // [B, Chid]: mean of h3
  float* squeezed;     // [B, Csq]
  float* gate;         // [B, Chid], or null: no SE
  float* part;         // [groups, B, Cout, H, W] when groups > 1
  int B, Cin, Chid, Cout, Csq, H, W;
  int silu, groups, chunks_per_group, pool_groups;
};

// What only the v1 entry points read: the norms' parameters, FiLM (rows of
// [B, >= Chid], row strides given) and the statistics' scratch.
struct Norms {
  const float* gn1_scale;
  const float* gn1_bias;   // [Cin]
  const float* gn2_scale;
  const float* gn2_bias;   // [Chid]
  const float* film_scale;
  const float* film_shift;  // [B, Chid] rows
  float* a1;
  float* b1;
  float* a2;
  float* b2;                // written: the affines irb_pool and irb_out read
  float* stats1;            // [B, stat_groups, 2, Cin]
  float* stats2;            // [B, pool_groups, 2, Chid]
  int g1, g2, stat_groups, fs_stride, fb_stride;
};

// Order of the pointers and ints the entry points take.
enum Ptr { kX, kA1, kB1, kA2, kB2, kWexp, kWdw, kWproj, kWskip, kSeW1, kSeB1, kSeW2, kSeB2,
           kOut, kPool, kPooled, kSqueezed, kGate, kPart, kGn1Scale, kGn1Bias, kGn2Scale,
           kGn2Bias, kFilmScale, kFilmShift, kStats1, kStats2, kNumPtrs };
enum Dim { kBatch, kCin, kChid, kCout, kCsq, kHeight, kWidth, kSilu, kUseSe, kTileH, kTileW,
           kChunk, kGroups, kChunksPerGroup, kPoolGroups, kStatGroups, kG1, kG2,
           kFsStride, kFbStride, kNumDims };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// An operand of a product: rounded to bf16 when R (v2's bf16 path, as the
// TPU kernel's bf16 dots), as is otherwise (f32, and v1's bf16 path).
template <bool R> __device__ __forceinline__ float op(float v) { return v; }
template <> __device__ __forceinline__ float op<true>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// v2 rounds the products' operands on its bf16 path; v1 never does.
template <typename T> constexpr bool kRoundV2 = sizeof(T) == 2;

__device__ __forceinline__ float act(float v, int silu) {
  return silu ? v / (1.f + expf(-v)) : fminf(fmaxf(v, 0.f), 6.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// dst[at(i)] = value(i) for i < n, the block's threads striding over i with
// U values each in flight, so that the loads behind value() overlap.
template <int U, typename At, typename Value>
__device__ __forceinline__ void stage(float* dst, int n, At at, Value value) {
  for (int base = threadIdx.x; base < n; base += U * kThreads) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < n ? value(i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kThreads;
      if (i < n) dst[at(i)] = v[u];
    }
  }
}

// Asynchronous 4-byte copy from device to shared memory (cp.async); with
// valid false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// h2 for hidden channels c0 .. c0+CC-1 on the RH x RW pixels whose top-left
// corner is image pixel (gy0, gx0), into h2s[CC][HPP] (pixels row-major,
// HPP = RH*RW rounded up to 4). Zero at pixels outside the image and for
// channels >= Chid. Thread items are 4 consecutive pixels by 8 channels.
// x (KX channels at a time) and W_exp are copied into shared memory, two
// stages in flight: while the block multiplies one stage, the next one
// arrives (cp.async for f32; bf16 elements are 2 bytes, below cp.async's
// least copy, so the bf16 path loads them with the threads). Each thread then
// turns the x it copied into x-hat = act(a1 * x + b1) in place. xs holds 2
// stages of [KX][HPP], ws 2 of [KX][CC]. a1s, b1s [Cin] and a2s, b2s [CC]
// must be staged by the caller, and a barrier passed since; the caller
// synchronises before reading h2s. With RAW it writes h1 = x-hat . W_exp
// itself (zero outside the image) and reads no a2s, b2s.
template <typename T, bool R, int CC, int RH, int RW, bool RAW = false>
__device__ void expand_region(const Irb& p, int b, int gy0, int gx0, int c0, float* xs,
                              float* ws, float* h2s, const float* a1s, const float* b1s,
                              const float* a2s, const float* b2s) {
  constexpr int HP = RH * RW;
  constexpr int HPQ = (HP + 3) / 4;
  constexpr int HPP = HPQ * 4;
  constexpr int NI = HPQ * (CC / 8);
  constexpr int PER = (HPP + kThreads - 1) / kThreads;  // region pixels a thread copies
  static_assert(CC % 8 == 0, "hidden chunk must be a multiple of 8");
  static_assert(NI <= kThreads, "one item a thread");
  const size_t plane = static_cast<size_t>(p.H) * p.W;
  const T* xb = static_cast<const T*>(p.x) + static_cast<size_t>(b) * p.Cin * plane;
  const int item = threadIdx.x;
  const bool active = item < NI;
  const int q = item % HPQ;
  const int o = item / HPQ;
  // the region pixels this thread copies, the same for every channel: their
  // offsets in a channel plane, or -1 outside the image (or the region)
  int off[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int rp = threadIdx.x + j * kThreads;
    const int gy = gy0 + rp / RW, gx = gx0 + rp % RW;
    off[j] = rp < HP && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W ? gy * p.W + gx : -1;
  }
  auto fetch = [&](int k0, int stage) {
    const int kn = min(KX, p.Cin - k0);
    float* xd = xs + stage * KX * HPP;
    for (int k = 0; k < kn; ++k) {
      const T* src = xb + (k0 + k) * plane;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int rp = threadIdx.x + j * kThreads;
        if (PER * kThreads == HPP || rp < HPP) {
          if constexpr (sizeof(T) == 4)
            cp_async4(xd + k * HPP + rp, reinterpret_cast<const float*>(off[j] < 0 ? xb : src + off[j]),
                      off[j] >= 0);
          else
            xd[k * HPP + rp] = off[j] < 0 ? 0.f : load_f32(src + off[j]);
        }
      }
    }
    // W_exp[c0 .. c0+CC)[k0 .. k0+kn) into wd[k][c], reading along k
    float* wd = ws + stage * KX * CC;
    for (int i = threadIdx.x; i < kn * CC; i += kThreads) {
      const int k = i % kn, c = c0 + i / kn;
      cp_async4(wd + k * CC + i / kn,
                c < p.Chid ? p.wexp + static_cast<size_t>(c) * p.Cin + k0 + k : p.wexp, c < p.Chid);
    }
    cp_async_commit();
  };
  // x-hat = act(a1 * x + b1), op-rounded, on the elements this thread copied
  // (outside the image too: h2 is set to zero there below)
  auto normalize = [&](int k0, int stage) {
    const int kn = min(KX, p.Cin - k0);
    float* xd = xs + stage * KX * HPP;
    for (int k = 0; k < kn; ++k) {
      const float a = a1s[k0 + k], c = b1s[k0 + k];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int rp = threadIdx.x + j * kThreads;
        if (PER * kThreads == HPP || rp < HPP)
          xd[k * HPP + rp] = op<R>(act(fmaf(a, xd[k * HPP + rp], c), p.silu));
      }
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int stages = (p.Cin + KX - 1) / KX;
  fetch(0, 0);
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      fetch((st + 1) * KX, (st + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    normalize(st * KX, st & 1);
    __syncthreads();
    const float* xk = xs + (st & 1) * KX * HPP;
    const float* wk = ws + (st & 1) * KX * CC;
    const int kn = min(KX, p.Cin - st * KX);
    if (active) {
      for (int k = 0; k < kn; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(xk + k * HPP + q * 4);
        const float4 w0 = *reinterpret_cast<const float4*>(wk + k * CC + o * 8);
        const float4 w1 = *reinterpret_cast<const float4*>(wk + k * CC + o * 8 + 4);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
        const float wa[8] = {op<R>(w0.x), op<R>(w0.y), op<R>(w0.z), op<R>(w0.w),
                             op<R>(w1.x), op<R>(w1.y), op<R>(w1.z), op<R>(w1.w)};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xa[i], wa[j], acc[i][j]);
      }
    }
    __syncthreads();  // this stage's buffers are free for the stage after next
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = o * 8 + j;
      float h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rp = q * 4 + i;
        const int gy = gy0 + rp / RW, gx = gx0 + rp % RW;
        const bool inside = rp < HP && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W &&
                            c0 + c < p.Chid;
        if constexpr (RAW)
          h[i] = inside ? acc[i][j] : 0.f;
        else
          h[i] = inside ? act(fmaf(a2s[c], acc[i][j], b2s[c]), p.silu) : 0.f;
      }
      *reinterpret_cast<float4*>(h2s + c * HPP + q * 4) = make_float4(h[0], h[1], h[2], h[3]);
    }
  }
}

// acc[MP][8] += A[k][p0 .. p0+MP) (x) Bm[k][co0 .. co0+8) over k < kn, both
// in shared memory (A rows of length lda, Bm rows of length ldb).
template <int MP>
__device__ __forceinline__ void tile_fma(float (&acc)[MP][8], const float* A, int lda, int p0,
                                         const float* Bm, int ldb, int co0, int kn) {
  for (int k = 0; k < kn; ++k) {
    float a[MP];
#pragma unroll
    for (int i = 0; i < MP; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(A + k * lda + p0 + i);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
    }
    const float4 w0 = *reinterpret_cast<const float4*>(Bm + k * ldb + co0);
    const float4 w1 = *reinterpret_cast<const float4*>(Bm + k * ldb + co0 + 4);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

template <int CO_PAD> struct OutLayout {
  static constexpr int TH = OutCfg<CO_PAD>::TH, TW = OutCfg<CO_PAD>::TW, CC = OutCfg<CO_PAD>::CC;
  static constexpr int P = TH * TW;
  static constexpr int RH = TH + 2, RW = TW + 2;
  static constexpr int HPP = (RH * RW + 3) / 4 * 4;
  static constexpr int TC = CO_PAD / 8;          // threads across output channels
  static constexpr int MP = P * TC / kThreads;   // pixels a thread accumulates
  // shared memory, in floats: two x stages (later h3, then the skip's x),
  // two W_exp stages, h2, W_proj, then a2, b2, gate [CC], the depthwise
  // taps [CC][9] and (not counted here: Cin is known at launch) a1, b1 [Cin]
  static constexpr int XS = 2 * KX * HPP > CC * P ? 2 * KX * HPP : CC * P;
  static constexpr int WS = 2 * KX * CC;
  static constexpr int H2 = CC * HPP;
  static constexpr int WP = KP * CO_PAD;
  static constexpr int FLOATS = XS + WS + H2 + WP + 12 * CC;
  static_assert(MP == 4 || MP == 8, "thread tile");
  static_assert(TW % 8 == 0 && TW % MP == 0, "tile width");
  static_assert(KC * P <= XS, "skip staging fits");
};

template <typename T, bool R, int CO_PAD>
__global__ void __launch_bounds__(kThreads, 2) irb_out(Irb p) {
  using L = OutLayout<CO_PAD>;
  constexpr int TH = L::TH, TW = L::TW, CC = L::CC, P = L::P, RW = L::RW, HPP = L::HPP;
  constexpr int MP = L::MP, TC = L::TC;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // x staging; h3 [CC][P]; skip staging
  float* ws = xs + L::XS;
  float* h2s = ws + L::WS;
  float* wps = h2s + L::H2;
  float* a2s = wps + L::WP;
  float* b2s = a2s + CC;
  float* gts = b2s + CC;
  float* wds = gts + CC;
  float* a1s = wds + 9 * CC;
  float* b1s = a1s + p.Cin;
  float* h3s = xs;

  const int tiles_x = (p.W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  // blockIdx.y walks the hidden groups of each block of CO_PAD output
  // channels; only CO_PAD = 256 has more than one such block (Cout > 256)
  const int g = blockIdx.y % p.groups, b = blockIdx.z;
  const int co_base = (blockIdx.y / p.groups) * CO_PAD;
  const int tid = threadIdx.x;
  const int co0 = (tid % TC) * 8, p0 = (tid / TC) * MP;
  const int nchunks = (p.Chid + CC - 1) / CC;
  const int ch_begin = g * p.chunks_per_group;
  const int ch_end = min(nchunks, ch_begin + p.chunks_per_group);
  const size_t plane = static_cast<size_t>(p.H) * p.W;

  float acc[MP][8];
#pragma unroll
  for (int i = 0; i < MP; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int i = tid; i < p.Cin; i += kThreads) {
    a1s[i] = p.a1[static_cast<size_t>(b) * p.Cin + i];
    b1s[i] = p.b1[static_cast<size_t>(b) * p.Cin + i];
  }

  for (int chunk = ch_begin; chunk < ch_end; ++chunk) {
    const int c0 = chunk * CC;
    __syncthreads();  // the previous chunk is done with a2s .. wds and h3s
    for (int i = tid; i < CC; i += kThreads) {
      const int c = c0 + i;
      const bool ok = c < p.Chid;
      const size_t bc = static_cast<size_t>(b) * p.Chid + c;
      a2s[i] = ok ? p.a2[bc] : 0.f;
      b2s[i] = ok ? p.b2[bc] : 0.f;
      gts[i] = ok ? (p.gate ? p.gate[bc] : 1.f) : 0.f;
    }
    for (int i = tid; i < CC * 9; i += kThreads)
      wds[i] = c0 + i / 9 < p.Chid ? p.wdw[static_cast<size_t>(c0) * 9 + i] : 0.f;
    expand_region<T, R, CC, TH + 2, TW + 2>(p, b, y0 - 1, x0 - 1, c0, xs, ws, h2s, a1s, b1s,
                                            a2s, b2s);
    __syncthreads();

    // depthwise 3x3 and gate: a thread item is 8 consecutive pixels of a row
    constexpr int NSEG = TW / 8;
    for (int i = tid; i < CC * TH * NSEG; i += kThreads) {
      const int s = i % NSEG, y = (i / NSEG) % TH, c = i / (NSEG * TH);
      const float* hrow = h2s + c * HPP + y * RW + s * 8;  // region row y = image row y0+y-1
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float r[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) r[j] = hrow[dy * RW + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float w = wds[c * 9 + dy * 3 + dx];
#pragma unroll
          for (int j = 0; j < 8; ++j) o[j] = fmaf(w, r[j + dx], o[j]);
        }
      }
      const float gt = gts[c];
      float* dst = h3s + c * P + y * TW + s * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = op<R>(o[j] * gt);
    }

    // project: acc += h3 . W_proj, KP hidden channels of W_proj at a time
    for (int k0 = 0; k0 < CC; k0 += KP) {
      const int kn = min(KP, CC - k0);
      __syncthreads();
      // wps[k][co] = W_proj[co][c0 + k0 + k], reading along k
      stage<4>(wps, kn * CO_PAD, [&](int i) { return (i % kn) * CO_PAD + i / kn; }, [&](int i) {
        const int co = co_base + i / kn, c = c0 + k0 + i % kn;
        return co < p.Cout && c < p.Chid ? op<R>(p.wproj[static_cast<size_t>(co) * p.Chid + c])
                                         : 0.f;
      });
      __syncthreads();
      tile_fma<MP>(acc, h3s + k0 * P, P, p0, wps, CO_PAD, co0, kn);
    }
  }

  const T* xb = static_cast<const T*>(p.x) + static_cast<size_t>(b) * p.Cin * plane;
  if (g == 0 && p.wskip) {  // acc += x . W_skip
    for (int k0 = 0; k0 < p.Cin; k0 += KC) {
      const int kn = min(KC, p.Cin - k0);
      __syncthreads();
      stage<4>(xs, kn * P, [](int i) { return i; }, [&](int i) {
        const int k = k0 + i / P, pp = i % P;
        const int y = y0 + pp / TW, x = x0 + pp % TW;
        return y < p.H && x < p.W
                   ? op<R>(load_f32(xb + k * plane + static_cast<size_t>(y) * p.W + x))
                   : 0.f;
      });
      // wps[k][co] = W_skip[co][k0 + k], reading along k
      stage<4>(wps, kn * CO_PAD, [&](int i) { return (i % kn) * CO_PAD + i / kn; }, [&](int i) {
        const int co = co_base + i / kn, k = k0 + i % kn;
        return co < p.Cout ? op<R>(p.wskip[static_cast<size_t>(co) * p.Cin + k]) : 0.f;
      });
      __syncthreads();
      tile_fma<MP>(acc, xs, P, p0, wps, CO_PAD, co0, kn);
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co_base + co0 + j;
    if (co >= p.Cout) continue;
#pragma unroll
    for (int i = 0; i < MP; ++i) {
      const int pp = p0 + i;
      const int y = y0 + pp / TW, x = x0 + pp % TW;
      if (y >= p.H || x >= p.W) continue;
      const size_t at = static_cast<size_t>(co) * plane + static_cast<size_t>(y) * p.W + x;
      float v = acc[i][j];
      if (g == 0 && !p.wskip) v += load_f32(xb + at);  // identity residual (Cin == Cout)
      const size_t bo = static_cast<size_t>(b) * p.Cout * plane + at;
      if (p.groups == 1)
        store_from_f32(static_cast<T*>(p.out) + bo, v);
      else
        p.part[static_cast<size_t>(g) * p.B * p.Cout * plane + bo] = v;
    }
  }
}

// SE pool partials: per (batch, pixel group, channel) the nine sums of h2.
// A lane keeps the same pixels of every tile, so it accumulates across the
// group's tiles and the warp reduces once at the end; only tiles on the
// image's border add the edge and corner sums.
template <typename T, bool R>
__global__ void __launch_bounds__(kThreads) irb_pool(Irb p) {
  constexpr int CC = kPoolCC, HPP = kPoolTile * kPoolTile;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + 2 * KX * HPP;
  float* h2s = ws + 2 * KX * CC;
  float* a2s = h2s + CC * HPP;
  float* b2s = a2s + CC;
  float* a1s = b2s + CC;     // [Cin]
  float* b1s = a1s + p.Cin;

  const int tiles_x = (p.W + kPoolTile - 1) / kPoolTile;
  const int tiles = tiles_x * ((p.H + kPoolTile - 1) / kPoolTile);
  const int group = blockIdx.x, c0 = blockIdx.y * CC, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < CC; i += kThreads) {
    const int c = c0 + i;
    const size_t bc = static_cast<size_t>(b) * p.Chid + c;
    a2s[i] = c < p.Chid ? p.a2[bc] : 0.f;
    b2s[i] = c < p.Chid ? p.b2[bc] : 0.f;
  }
  for (int i = tid; i < p.Cin; i += kThreads) {
    a1s[i] = p.a1[static_cast<size_t>(b) * p.Cin + i];
    b1s[i] = p.b1[static_cast<size_t>(b) * p.Cin + i];
  }
  __syncthreads();
  constexpr int CPW = CC / kWarps;  // channels a warp reduces
  float sums[CPW][9];
#pragma unroll
  for (int m = 0; m < CPW; ++m)
#pragma unroll
    for (int k = 0; k < 9; ++k) sums[m][k] = 0.f;

  for (int t = group; t < tiles; t += p.pool_groups) {
    const int ty0 = (t / tiles_x) * kPoolTile, tx0 = (t % tiles_x) * kPoolTile;
    expand_region<T, R, CC, kPoolTile, kPoolTile>(p, b, ty0, tx0, c0, xs, ws, h2s, a1s, b1s,
                                                  a2s, b2s);
    __syncthreads();
    const bool border = ty0 == 0 || tx0 == 0 || ty0 + kPoolTile >= p.H || tx0 + kPoolTile >= p.W;
#pragma unroll
    for (int m = 0; m < CPW; ++m) {
      const float* hc = h2s + (warp + kWarps * m) * HPP;  // zero outside the image
      if (!border) {
#pragma unroll
        for (int pp = lane; pp < HPP; pp += 32) sums[m][0] += hc[pp];
        continue;
      }
      for (int pp = lane; pp < HPP; pp += 32) {
        const int gy = ty0 + pp / kPoolTile, gx = tx0 + pp % kPoolTile;
        const float v = hc[pp];
        const bool r0 = gy == 0, rl = gy == p.H - 1, q0 = gx == 0, ql = gx == p.W - 1;
        sums[m][0] += v;
        sums[m][1] += r0 ? v : 0.f;
        sums[m][2] += rl ? v : 0.f;
        sums[m][3] += q0 ? v : 0.f;
        sums[m][4] += ql ? v : 0.f;
        sums[m][5] += r0 && q0 ? v : 0.f;
        sums[m][6] += r0 && ql ? v : 0.f;
        sums[m][7] += rl && q0 ? v : 0.f;
        sums[m][8] += rl && ql ? v : 0.f;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < CPW; ++m) {
    const int c = c0 + warp + kWarps * m;
    float* dst = p.pool + (static_cast<size_t>(b) * p.pool_groups + group) * 9 * p.Chid + c;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float v = warp_sum(sums[m][k]);
      if (lane == 0 && c < p.Chid) dst[static_cast<size_t>(k) * p.Chid] = v;
    }
  }
}

// SE pool, continued: grid (Chid/32, B). The mean of h3 per (batch,
// channel) from the nine sums, the pixel groups' partials summed in a fixed
// order (warp w takes groups w, w + 8, ...; then warp 0 adds the warps').
__global__ void __launch_bounds__(kThreads) irb_pooled(Irb p) {
  __shared__ float part[kWarps][9][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane, b = blockIdx.y;
  float t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = 0.f;
  if (c < p.Chid) {
    for (int g = warp; g < p.pool_groups; g += kWarps) {
      const float* src = p.pool + (static_cast<size_t>(b) * p.pool_groups + g) * 9 * p.Chid + c;
#pragma unroll
      for (int k = 0; k < 9; ++k) t[k] += src[static_cast<size_t>(k) * p.Chid];
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) part[warp][k][lane] = t[k];
  __syncthreads();
  if (warp != 0 || c >= p.Chid) return;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    t[k] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t[k] += part[w][k][lane];
  }
  // tap (dy, dx) reads h2 at (y + dy - 1, x + dx - 1): its sum over the
  // image is the total less the row and column it never reaches, plus the
  // corner both excluded
  float pooled = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float s = t[0];
      if (dy == 0) s -= t[2];
      if (dy == 2) s -= t[1];
      if (dx == 0) s -= t[4];
      if (dx == 2) s -= t[3];
      if (dy == 0 && dx == 0) s += t[8];
      if (dy == 0 && dx == 2) s += t[7];
      if (dy == 2 && dx == 0) s += t[6];
      if (dy == 2 && dx == 2) s += t[5];
      pooled = fmaf(p.wdw[static_cast<size_t>(c) * 9 + dy * 3 + dx], s, pooled);
    }
  p.pooled[static_cast<size_t>(b) * p.Chid + c] =
      pooled / (static_cast<float>(p.H) * static_cast<float>(p.W));
}

// SE fc1 -> act: grid (Csq/8, B), a warp per squeezed channel.
__global__ void __launch_bounds__(kThreads) irb_se_fc1(Irb p) {
  const int j = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  if (j >= p.Csq) return;
  const float* v = p.pooled + static_cast<size_t>(b) * p.Chid;
  const float* w = p.se_w1 + static_cast<size_t>(j) * p.Chid;
  float d = 0.f;
  for (int c = lane; c < p.Chid; c += 32) d = fmaf(v[c], w[c], d);
  d = warp_sum(d);
  if (lane == 0) p.squeezed[static_cast<size_t>(b) * p.Csq + j] = act(d + p.se_b1[j], p.silu);
}

// SE fc2 -> sigmoid: grid (Chid/8, B), a warp per hidden channel.
__global__ void __launch_bounds__(kThreads) irb_se_fc2(Irb p) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  if (c >= p.Chid) return;
  const float* v = p.squeezed + static_cast<size_t>(b) * p.Csq;
  const float* w = p.se_w2 + static_cast<size_t>(c) * p.Csq;
  float d = 0.f;
  for (int j = lane; j < p.Csq; j += 32) d = fmaf(v[j], w[j], d);
  d = warp_sum(d);
  if (lane == 0)
    p.gate[static_cast<size_t>(b) * p.Chid + c] = 1.f / (1.f + expf(-(d + p.se_b2[c])));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) irb_combine(const float* __restrict__ part,
                                                        T* __restrict__ out, size_t n,
                                                        int groups) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part[static_cast<size_t>(g) * n + i];
    store_from_f32(out + i, s);
  }
}

// v1, GN1 statistics: grid (stat groups, B). The block's pixels are one
// stretch of each channel plane; warp w sums x and x^2 of channels w, w + 8,
// ... over them (a lane every 32nd pixel) and writes the channel's partial.
template <typename T>
__global__ void __launch_bounds__(kThreads) irb_gn1_stats(Irb p, Norms n) {
  const int group = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int plane = p.H * p.W;
  const int per = (plane + n.stat_groups - 1) / n.stat_groups;
  const int lo = group * per, hi = min(plane, lo + per);
  const T* xb = static_cast<const T*>(p.x) + static_cast<size_t>(b) * p.Cin * plane;
  for (int c = warp; c < p.Cin; c += kWarps) {
    const T* src = xb + static_cast<size_t>(c) * plane;
    float s = 0.f, s2 = 0.f;
    for (int i = lo + lane; i < hi; i += 32) {
      const float v = load_f32(src + i);
      s += v;
      s2 = fmaf(v, v, s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      float* dst = n.stats1 + (static_cast<size_t>(b) * n.stat_groups + group) * 2 * p.Cin + c;
      dst[0] = s;
      dst[p.Cin] = s2;
    }
  }
}

// v1, GN2 statistics: the pool pass's grid (pixel groups, Chid/32, B). The
// block recomputes h1 on its group's 16 x 16 tiles for 32 hidden channels
// and writes per-channel partial sums of h1 and h1^2 (zero outside the
// image, so a ragged tile adds nothing).
template <typename T>
__global__ void __launch_bounds__(kThreads) irb_gn2_stats(Irb p, Norms n) {
  constexpr int CC = kPoolCC, HPP = kPoolTile * kPoolTile;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + 2 * KX * HPP;
  float* h1s = ws + 2 * KX * CC;
  float* a1s = h1s + CC * HPP;  // [Cin]
  float* b1s = a1s + p.Cin;

  const int tiles_x = (p.W + kPoolTile - 1) / kPoolTile;
  const int tiles = tiles_x * ((p.H + kPoolTile - 1) / kPoolTile);
  const int group = blockIdx.x, c0 = blockIdx.y * CC, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < p.Cin; i += kThreads) {
    a1s[i] = p.a1[static_cast<size_t>(b) * p.Cin + i];
    b1s[i] = p.b1[static_cast<size_t>(b) * p.Cin + i];
  }
  __syncthreads();
  constexpr int CPW = CC / kWarps;
  float s[CPW], s2[CPW];
#pragma unroll
  for (int m = 0; m < CPW; ++m) s[m] = s2[m] = 0.f;
  for (int t = group; t < tiles; t += p.pool_groups) {
    const int ty0 = (t / tiles_x) * kPoolTile, tx0 = (t % tiles_x) * kPoolTile;
    expand_region<T, false, CC, kPoolTile, kPoolTile, true>(p, b, ty0, tx0, c0, xs, ws, h1s, a1s,
                                                            b1s, nullptr, nullptr);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < CPW; ++m) {
      const float* hc = h1s + (warp + kWarps * m) * HPP;
#pragma unroll
      for (int pp = lane; pp < HPP; pp += 32) {
        const float v = hc[pp];
        s[m] += v;
        s2[m] = fmaf(v, v, s2[m]);
      }
    }
    // the next tile's expand overwrites h1s only after its first barrier
  }
#pragma unroll
  for (int m = 0; m < CPW; ++m) {
    const int c = c0 + warp + kWarps * m;
    const float t = warp_sum(s[m]), t2 = warp_sum(s2[m]);
    if (lane == 0 && c < p.Chid) {
      float* dst = n.stats2 + (static_cast<size_t>(b) * p.pool_groups + group) * 2 * p.Chid + c;
      dst[0] = t;
      dst[p.Chid] = t2;
    }
  }
}

// v1: one GroupNorm's per-(batch, channel) affine from the per-channel
// partials part [B, P, 2, C]: grid (G, B), a block per group. The group's
// P x C/G partials are summed in a fixed order (thread-strided, then each
// warp, then the warps in turn), mean = S / n, var = max(S2 / n - mean^2,
// 0), rstd = rsqrt(var + eps) with n = pixels x C/G, as the TPU kernel
// (pallas_irb.py:159-168, 184-194). Then, per channel, the norm and FiLM
// ((v - mean) * rstd * gamma + beta) * (1 + fs) + fb as a * v + b (without
// FiLM: fs = fb = 0).
__global__ void __launch_bounds__(kThreads) irb_gn_finalize(
    const float* __restrict__ part, int P, int C, int G, int pixels, const float* gamma,
    const float* beta, const float* fs, int fs_stride, const float* fb, int fb_stride, float eps,
    float* a, float* bias) {
  __shared__ float red[2][kWarps];
  __shared__ float stat[2];
  const int g = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = C / G, items = P * per;
  float s = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const float* src = part + (static_cast<size_t>(b) * P + i / per) * 2 * C + g * per + i % per;
    s += src[0];
    s2 += src[C];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f, t2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      t += red[0][w];
      t2 += red[1][w];
    }
    const float count = static_cast<float>(pixels) * static_cast<float>(per);
    const float mean = t / count;
    const float var = fmaxf(t2 / count - mean * mean, 0.f);
    stat[0] = mean;
    stat[1] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  for (int j = threadIdx.x; j < per; j += kThreads) {
    const int c = g * per + j;
    const float sc = rstd * gamma[c];
    const float m = fs ? 1.f + fs[static_cast<size_t>(b) * fs_stride + c] : 1.f;
    const float f = fb ? fb[static_cast<size_t>(b) * fb_stride + c] : 0.f;
    a[static_cast<size_t>(b) * C + c] = sc * m;
    bias[static_cast<size_t>(b) * C + c] = fmaf(beta[c] - mean * sc, m, f);
  }
}

// Dynamic shared memory above 48 KB has to be allowed per kernel; done once
// for the largest request, so a later launch (or a CUDA graph capture) calls
// no cudaFuncSetAttribute.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <typename T, bool R, int CO_PAD>
cudaError_t launch_out(const Irb& p, const int* dim, cudaStream_t st) {
  using L = OutLayout<CO_PAD>;
  if (dim[kTileH] != L::TH || dim[kTileW] != L::TW || dim[kChunk] != L::CC)
    return cudaErrorInvalidValue;  // the wrapper's tile table disagrees with this build
  const size_t smem = sizeof(float) * (L::FLOATS + 2 * p.Cin);
  cudaError_t err = allow_smem<irb_out<T, R, CO_PAD>>(smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((p.H + L::TH - 1) / L::TH) * ((p.W + L::TW - 1) / L::TW);
  const int co_blocks = (p.Cout + CO_PAD - 1) / CO_PAD;
  if (p.groups * co_blocks > 65535) return cudaErrorInvalidValue;
  irb_out<T, R, CO_PAD><<<dim3(tiles, p.groups * co_blocks, p.B), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// The Irb of an entry point's arrays; false if they cannot describe an IRB.
bool parse(const void* const* ptr, const int* dim, Irb& p) {
  p.x = ptr[kX];
  p.a1 = static_cast<const float*>(ptr[kA1]);
  p.b1 = static_cast<const float*>(ptr[kB1]);
  p.a2 = static_cast<const float*>(ptr[kA2]);
  p.b2 = static_cast<const float*>(ptr[kB2]);
  p.wexp = static_cast<const float*>(ptr[kWexp]);
  p.wdw = static_cast<const float*>(ptr[kWdw]);
  p.wproj = static_cast<const float*>(ptr[kWproj]);
  p.wskip = static_cast<const float*>(ptr[kWskip]);
  p.se_w1 = static_cast<const float*>(ptr[kSeW1]);
  p.se_b1 = static_cast<const float*>(ptr[kSeB1]);
  p.se_w2 = static_cast<const float*>(ptr[kSeW2]);
  p.se_b2 = static_cast<const float*>(ptr[kSeB2]);
  p.out = const_cast<void*>(ptr[kOut]);
  p.pool = static_cast<float*>(const_cast<void*>(ptr[kPool]));
  p.pooled = static_cast<float*>(const_cast<void*>(ptr[kPooled]));
  p.squeezed = static_cast<float*>(const_cast<void*>(ptr[kSqueezed]));
  p.gate = static_cast<float*>(const_cast<void*>(ptr[kGate]));
  p.part = static_cast<float*>(const_cast<void*>(ptr[kPart]));
  p.B = dim[kBatch];
  p.Cin = dim[kCin];
  p.Chid = dim[kChid];
  p.Cout = dim[kCout];
  p.Csq = dim[kCsq];
  p.H = dim[kHeight];
  p.W = dim[kWidth];
  p.silu = dim[kSilu];
  p.groups = dim[kGroups];
  p.chunks_per_group = dim[kChunksPerGroup];
  p.pool_groups = dim[kPoolGroups];
  const bool use_se = dim[kUseSe] != 0;
  if (p.B <= 0 || p.Cin <= 0 || p.Chid <= 0 || p.Cout <= 0 || p.H <= 0 ||
      p.W <= 0 || p.groups <= 0 || p.chunks_per_group <= 0 || !p.x || !p.a1 || !p.b1 || !p.a2 ||
      !p.b2 || !p.wexp || !p.wdw || !p.wproj || !p.out || (p.groups > 1 && !p.part) ||
      (!p.wskip && p.Cin != p.Cout))
    return false;
  if (use_se) {
    if (p.Csq <= 0 || p.pool_groups <= 0 || !p.se_w1 || !p.se_b1 || !p.se_w2 || !p.se_b2 ||
        !p.pool || !p.pooled || !p.squeezed || !p.gate)
      return false;
  } else {
    p.gate = nullptr;
  }
  return true;
}

// Everything after the norms' affines: the SE pool and gate, the output
// pass and the combine. R: round the products' operands to bf16.
template <typename T, bool R>
cudaError_t launch_irb(const Irb& p, const int* dim, cudaStream_t st) {
  cudaError_t err;
  if (p.gate) {
    const size_t pool_smem =
        sizeof(float) * (2 * KX * kPoolTile * kPoolTile + 2 * KX * kPoolCC +
                         kPoolCC * kPoolTile * kPoolTile + 2 * kPoolCC + 2 * p.Cin);
    err = allow_smem<irb_pool<T, R>>(pool_smem);
    if (err != cudaSuccess) return err;
    irb_pool<T, R><<<dim3(p.pool_groups, (p.Chid + kPoolCC - 1) / kPoolCC, p.B), kThreads,
                     pool_smem, st>>>(p);
    irb_pooled<<<dim3((p.Chid + 31) / 32, p.B), kThreads, 0, st>>>(p);
    irb_se_fc1<<<dim3((p.Csq + kWarps - 1) / kWarps, p.B), kThreads, 0, st>>>(p);
    irb_se_fc2<<<dim3((p.Chid + kWarps - 1) / kWarps, p.B), kThreads, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const int co_pad = p.Cout <= 32 ? 32 : p.Cout <= 64 ? 64 : p.Cout <= 128 ? 128 : 256;
  switch (co_pad) {
    case 32: err = launch_out<T, R, 32>(p, dim, st); break;
    case 64: err = launch_out<T, R, 64>(p, dim, st); break;
    case 128: err = launch_out<T, R, 128>(p, dim, st); break;
    default: err = launch_out<T, R, 256>(p, dim, st); break;
  }
  if (err != cudaSuccess || p.groups == 1) return err;
  const size_t n = static_cast<size_t>(p.B) * p.Cout * p.H * p.W;
  const size_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 2048 ? want : 2048);
  irb_combine<T><<<blocks, kThreads, 0, st>>>(p.part, static_cast<T*>(p.out), n, p.groups);
  return cudaGetLastError();
}

// v2: the affines arrive folded.
template <typename T>
cudaError_t run_v2(const void* const* ptr, const int* dim, void* stream) {
  Irb p;
  if (!parse(ptr, dim, p)) return cudaErrorInvalidValue;
  return launch_irb<T, kRoundV2<T>>(p, dim, static_cast<cudaStream_t>(stream));
}

// v1: the norms' statistics and affines first, written into the a1, b1,
// a2, b2 arrays, then the same passes, with f32 operands in every product.
template <typename T>
cudaError_t run_v1(const void* const* ptr, const int* dim, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Irb p;
  if (!parse(ptr, dim, p)) return cudaErrorInvalidValue;
  Norms n;
  n.gn1_scale = static_cast<const float*>(ptr[kGn1Scale]);
  n.gn1_bias = static_cast<const float*>(ptr[kGn1Bias]);
  n.gn2_scale = static_cast<const float*>(ptr[kGn2Scale]);
  n.gn2_bias = static_cast<const float*>(ptr[kGn2Bias]);
  n.film_scale = static_cast<const float*>(ptr[kFilmScale]);
  n.film_shift = static_cast<const float*>(ptr[kFilmShift]);
  n.a1 = const_cast<float*>(p.a1);
  n.b1 = const_cast<float*>(p.b1);
  n.a2 = const_cast<float*>(p.a2);
  n.b2 = const_cast<float*>(p.b2);
  n.stats1 = static_cast<float*>(const_cast<void*>(ptr[kStats1]));
  n.stats2 = static_cast<float*>(const_cast<void*>(ptr[kStats2]));
  n.g1 = dim[kG1];
  n.g2 = dim[kG2];
  n.stat_groups = dim[kStatGroups];
  n.fs_stride = dim[kFsStride];
  n.fb_stride = dim[kFbStride];
  if (!n.gn1_scale || !n.gn1_bias || !n.gn2_scale || !n.gn2_bias || !n.film_scale ||
      !n.film_shift || !n.stats1 || !n.stats2 || n.g1 <= 0 || p.Cin % n.g1 || n.g2 <= 0 ||
      p.Chid % n.g2 || n.stat_groups <= 0 || p.pool_groups <= 0 || n.fs_stride < p.Chid ||
      n.fb_stride < p.Chid || !(eps > 0.f))
    return cudaErrorInvalidValue;
  const int pixels = p.H * p.W;

  irb_gn1_stats<T><<<dim3(n.stat_groups, p.B), kThreads, 0, st>>>(p, n);
  irb_gn_finalize<<<dim3(n.g1, p.B), kThreads, 0, st>>>(n.stats1, n.stat_groups, p.Cin, n.g1,
                                                       pixels, n.gn1_scale, n.gn1_bias, nullptr,
                                                       0, nullptr, 0, eps, n.a1, n.b1);
  const size_t stats_smem = sizeof(float) * (2 * KX * kPoolTile * kPoolTile + 2 * KX * kPoolCC +
                                             kPoolCC * kPoolTile * kPoolTile + 2 * p.Cin);
  cudaError_t err = allow_smem<irb_gn2_stats<T>>(stats_smem);
  if (err != cudaSuccess) return err;
  irb_gn2_stats<T><<<dim3(p.pool_groups, (p.Chid + kPoolCC - 1) / kPoolCC, p.B), kThreads,
                     stats_smem, st>>>(p, n);
  irb_gn_finalize<<<dim3(n.g2, p.B), kThreads, 0, st>>>(
      n.stats2, p.pool_groups, p.Chid, n.g2, pixels, n.gn2_scale, n.gn2_bias, n.film_scale,
      n.fs_stride, n.film_shift, n.fb_stride, eps, n.a2, n.b2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_irb<T, false>(p, dim, st);
}

}  // namespace

extern "C" {

int fused_irb_num_ptrs() { return kNumPtrs; }
int fused_irb_num_dims() { return kNumDims; }

cudaError_t fused_irb_f32(const void* const* ptr, const int* dim, void* stream) {
  return run_v2<float>(ptr, dim, stream);
}

cudaError_t fused_irb_bf16(const void* const* ptr, const int* dim, void* stream) {
  return run_v2<__nv_bfloat16>(ptr, dim, stream);
}

cudaError_t fused_irb_v1_f32(const void* const* ptr, const int* dim, float eps, void* stream) {
  return run_v1<float>(ptr, dim, eps, stream);
}

cudaError_t fused_irb_v1_bf16(const void* const* ptr, const int* dim, float eps, void* stream) {
  return run_v1<__nv_bfloat16>(ptr, dim, eps, stream);
}

const char* fused_irb_error_string(cudaError_t err) { return cudaGetErrorString(err); }

}  // extern "C"
