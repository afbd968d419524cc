// Fused stride-1 inverted residual block (IRB) forward for NVIDIA Hopper
// (sm_90a), hand-written CUDA C++, its three products on the tensor cores.
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
// XLA outside its kernel; v1 (below) computes them itself. The kernel reads x
// and applies act(a1 * x + b1) itself, as the TPU kernel does (pallas_irb.py:
// 440-441). Every weight is read in the layout of the port's module
// parameters: W_exp [Chid, Cin], W_proj [Cout, Chid], W_skip [Cout, Cin]. All
// three are K-major already, the layout a tensor-core B operand takes, so
// they go to shared memory untransposed and no call copies one.
//
// Replaces the TPU kernel `fused_irb_v2` (`_kernel_v2`,
// cv_diffusion_tpu/ops/pallas_irb.py:607). That kernel keeps a whole image
// of x in VMEM and walks a sequential (B, 2 phases, row tiles) grid,
// carrying the SE edge sums from one grid step to the next in scratch. Here
// blocks run in parallel and in no order, so the phases are launches:
//
//   pool (SE only): grid (pixel groups, hidden blocks, B). A block stages
//     x-hat = act(a1 x + b1) of an 8 x 16-pixel tile once and reuses it for
//     up to four hidden chunks of 64 channels (kPoolChunksMax): h2 of the tile
//     on the tensor cores, reduced straight from the MMA fragments to, per
//     channel, h2's total and its sums over the first and last row, the first
//     and last column and the four corners (only tiles on the image's border
//     pay for the eight edge sums), into scratch [B, groups, 9, Chid]. The
//     mean of h3 follows exactly from those nine sums (the v2 identity,
//     pallas_irb.py:449-516), so the pool pass needs no halo and no depthwise.
//   gate (SE only): three small launches. Sum the partials in a fixed order
//     and form the mean of h3 [B, Chid]; fc1 -> act [B, Csq]; fc2 -> sigmoid
//     into gate [B, Chid].
//   out: grid (tiles, hidden groups x output blocks, B). A block owns a
//     TH x TW output tile of up to CO_PAD output channels (OutCfg; wider
//     outputs, 384 and 512 in the base and large UNets, take several blocks
//     of 256, each of which redoes the tile's expand). It stages x-hat of the
//     tile and its one-pixel halo once, then loops over chunks of CC hidden
//     channels: the expand (region pixels x CC) on the tensor cores, h2 =
//     act(a2 h1 + b2) into shared memory (zero outside the image), the
//     nine-tap depthwise times the gate on the CUDA cores (h3 overwrites h2),
//     and h3 . W_proj on the tensor cores, accumulated in the MMA fragments
//     across all chunks. The first hidden group adds x . W_skip (tensor
//     cores) or x. With one group the block writes out; with several (small
//     images, where tiles alone cannot fill 132 SMs) each writes an f32
//     partial, and
//   combine: sums the partials in a fixed order into out.
//
// No atomics anywhere, and every sum is taken in a fixed order, so reruns are
// bit-identical.
//
// Products. Each is a warp-level mma.sync: m16n8k8 in TF32 for float32
// operands, m16n8k16 in bf16 for v2's bf16 entry. Expand: rows are the tile's
// region pixels (A = x-hat, read from shared memory channel-major, as x
// arrives NCHW), columns the chunk's hidden channels (B = W_exp rows).
// Project: rows the tile's pixels (A = h3), columns the output channels
// (B = W_proj rows); skip likewise with A = x. Float32 operands go through
// 3xTF32: each is split into big = tf32(v) (to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds) and small = v - big cut to TF32, and
// small.big + big.small + big.big accumulate in float32, within a small
// factor of an f32 product (tests/test_torch_port_fused_irb_tc.py emulates
// it); a single TF32 pass would not meet the 2e-4 bound at K = 2048. The
// split is done as a fragment is loaded from shared memory. v2's bf16 entry
// rounds every product operand to bf16 (as the TPU kernel's bf16 dots,
// pallas_irb.py:426-427) with cvt.rn.bf16x2 at the fragment load and
// accumulates in float32. mma.sync and not wgmma: a warp's A fragment is
// built in registers from a channel-major tile (the split, or the bf16
// rounding, is applied on the way), and the expand's rows are the 100 to 252
// pixels of a halo region; wgmma's 64-row warpgroup tiles and its
// asynchronous issue are left for a later kernel.
// The depthwise 3 x 3, the gate and the activations stay on the CUDA cores.
//
// Staging. x (f32), W_proj, W_skip and the chunk's parameters go to shared
// memory by cp.async: 16-byte copies where the rows allow (x's interior
// columns when W % 4 == 0; weights when their K is a multiple of 4), 4-byte
// copies for the halo columns and otherwise, zero-filled outside the image
// and the matrices. bf16 x is loaded by the threads and widened (cp.async
// cannot convert). Each thread then turns the x it copied into x-hat in
// place. W_exp goes in slabs of KSO = 64 input channels (output pass) or
// KS = 32 (pool pass) through a two-slot ring: a slab is loaded into
// registers (16-byte loads) a stage ahead and stored to its slot once the
// current slab's products are issued, so its latency hides behind them.
// x-hat of a tile stays resident across all hidden chunks when it fits
// beside the ring, h2 and W_proj (227 KB a block); otherwise x streams
// through a two-slot ring of 64-channel slabs, once per hidden chunk. Per
// output tile, in floats: x-hat Cin x LDX (rows of TW + 4), the ring
// 2 x CC x 68, h2 CC x LDH (dense rows of TW + 2; h3 and the skip's x reuse
// it, and with x-hat resident so do a1 and b1 before the first h2), W_proj
// CO_PAD x (CC + 4), the chunk's parameters 12 x CC (Cin padded to 32):
//
//   CO_PAD  tile   CC  LDX  LDH  x-hat resident up to   small-UNet shapes that stream x
//   32      12x16  64  280  252  Cin 96                 none
//   64      8x16   48  200  180  Cin 192                none
//   128     8x16   64  200  180  Cin 128                384->1536->128 at 64x64
//   256     8x8    48  120  100  Cin 256                512->2048->256 at 32x32
//
// and every base/large shape above those widths. The pool pass keeps x-hat
// of its 8 x 16 tile (Cin x 136 floats) resident up to Cin 320 and streams
// it above. The expand's rows are the tile's region padded to 16: 256/192 =
// 1.33 of the tile at 12 x 16, 192/128 = 1.5 at 8 x 16, 112/64 = 1.75 at 8
// x 8; all of a tile's products fill whole 16-row MMA tiles.
//
// What bounds it on an H100: the three products per pixel are 2 * Chid *
// (Cin + Cout) FLOP (+ 2 * Cin * Cout with a skip) against (Cin + Cout) * 4
// bytes of x and out, 68 to 422 FLOP per byte at the small UNet's shapes. In
// 3xTF32 each product FLOP costs three TF32 FLOP at 495 TFLOP/s (an f32
// rate of 165 TFLOP/s), so 3xTF32 tensor-core operations bound every
// small-UNet shape, with bytes close behind at the 32-channel blocks at
// 256 x 256 (ridge ~49 FLOP per byte). The recomputed expand (halo, SE pool)
// and the CUDA-core depthwise come on top of that bound. Measured, the
// kernel stays far above it (17x per small-UNet call at batch 8 on an H100,
// PERF.md) with the tensor cores mostly idle: the fragment loads, splits,
// staging and barriers around each mma.sync limit it, not the MMAs.
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
//   gn2_stats: the pool pass with h1 = x-hat . W_exp (never in device
//     memory) in place of h2, reduced to per-channel partial sums of h1 and
//     h1^2: scratch [B, pool groups, 2, Chid]. GN2's groups (4 to 128
//     channels) may straddle the blocks' chunks or hold several; the finalize
//     pass sums whole groups from the channels.
//   gn_finalize for GN2, then the passes above (pool, gate, out, combine),
//     driven with the affines on the device.
//
// v1's products take f32 operands (3xTF32) in both of its entry points, as
// the TPU kernel casts every operand to f32; its bf16 entry reads x and
// writes out in bf16.
//
// The entry points launch on the caller's stream and return the cudaError_t
// of the launches; they allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KS = 32;                     // input channels per slab: x padding, pool, skip
constexpr int KSO = 64;                    // ... per stage of the output pass's expand
constexpr int kPoolTH = 8, kPoolTW = 16;   // pool pass: 8 x 16 pixels ...
constexpr int kPoolCC = 64;                // ... by hidden chunks of 64 channels,
constexpr int kPoolChunksMax = 4;          // at most 4 chunks a block
constexpr size_t kSmemMax = 232448;        // shared memory a block may take (H100)

// Output tile (TH x TW pixels), hidden chunk (CC), and how many warps split
// the rows of the expand (EWM) and of the project (PWM; the rest of the 8
// split the columns), for outputs padded to CO_PAD channels (above 256:
// blocks of 256). cv_diffusion_tpu_torch/ops/fused_irb_kernel.py holds the
// same tiles and chunks and passes them in; the launcher checks that they agree.
template <int CO_PAD> struct OutCfg;
template <> struct OutCfg<32> { static constexpr int TH = 12, TW = 16, CC = 64, EWM = 8, PWM = 4; };
template <> struct OutCfg<64> { static constexpr int TH = 8, TW = 16, CC = 48, EWM = 4, PWM = 4; };
template <> struct OutCfg<128> { static constexpr int TH = 8, TW = 16, CC = 64, EWM = 4, PWM = 4; };
template <> struct OutCfg<256> { static constexpr int TH = 8, TW = 8, CC = 48, EWM = 4, PWM = 2; };

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
  int silu, groups, chunks_per_group, pool_groups, pool_chunks;
  // 16-byte copies: x (f32, W % 4 == 0), W_exp and W_skip (Cin % 4 == 0),
  // W_proj (Chid % 4 == 0), each also 16-byte aligned
  int vec_x, vec_wexp, vec_wproj, vec_wskip;
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
           kFsStride, kFbStride, kPoolChunks, kNumDims };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The activation, chosen at compile time in the passes that apply it per
// element (a runtime choice would evaluate SiLU's exp and divide for ReLU6
// too), and at run time where it is applied once per output.
template <bool SILU> __device__ __forceinline__ float act(float v) {
  if constexpr (SILU) return __fdividef(v, 1.f + __expf(-v));   // 0 once exp(-v) passes 2^126
  else return fminf(fmaxf(v, 0.f), 6.f);
}
__device__ __forceinline__ float act(float v, int silu) {
  return silu ? act<true>(v) : act<false>(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Inline PTX: every Hopper instruction this file uses beyond plain C++.


// Two floats rounded to bf16 (to nearest even) and packed, lo in the low half.
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a (16 x 8, row) . b (8 x 8, col), TF32 in, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous copies from device to shared memory (cp.async); with valid
// false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// End of inline PTX.

// big = tf32(v), to nearest with ties away from zero (what cvt.rna.tf32.f32
// computes for finite v, in two integer operations: cvt.rna also checks for
// infinities and NaNs, four), small = v - big (exact in f32) cut to TF32
// toward zero; big + small is within 2^-21 of v, relatively.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

// Fragments of one MMA step: K columns of A and B per step; registers a lane
// holds of A (TF32: big[4] then small[4]) and of B (big[2] then small[2]).
template <bool BF> struct Frag {
  static constexpr int K = BF ? 16 : 8, AR = BF ? 4 : 8, BR = BF ? 2 : 4;
};

// This lane's A fragment of one step: its rows g and g + 8 start at r0 and
// r1 (column k = 2t for bf16, t for TF32), the next columns lda apart.
template <bool BF>
__device__ __forceinline__ void load_a(uint32_t* f, const float* r0, const float* r1, int lda) {
  if constexpr (BF) {
    f[0] = bf16x2_rn(r0[0], r0[lda]);
    f[1] = bf16x2_rn(r1[0], r1[lda]);
    f[2] = bf16x2_rn(r0[8 * lda], r0[9 * lda]);
    f[3] = bf16x2_rn(r1[8 * lda], r1[9 * lda]);
  } else {
    split_tf32(r0[0], f[0], f[4]);
    split_tf32(r1[0], f[1], f[5]);
    split_tf32(r0[4 * lda], f[2], f[6]);
    split_tf32(r1[4 * lda], f[3], f[7]);
  }
}

// This lane's B fragment of one step: its column g from row k = 2t (bf16)
// or t (TF32) on, at c.
template <bool BF>
__device__ __forceinline__ void load_b(uint32_t* f, const float* c) {
  if constexpr (BF) {
    const float2 v0 = *reinterpret_cast<const float2*>(c);
    const float2 v1 = *reinterpret_cast<const float2*>(c + 8);
    f[0] = bf16x2_rn(v0.x, v0.y);
    f[1] = bf16x2_rn(v1.x, v1.y);
  } else {
    split_tf32(c[0], f[0], f[2]);
    split_tf32(c[4], f[1], f[3]);
  }
}

// A warp's share of a product over K columns (a multiple of the step's):
// acc[i][j] += A . B, A element
// (row r, column k) at a[k * lda + off(r)] with this lane's rows of m-tile i
// at offsets ro[i], B element (k, column n) at b[n * ldb + k], n-tile j the
// columns 8j .. 8j + 7. The accumulator's element e of tile (i, j) is row
// g + 8 (e / 2), column 2t + e % 2. A step loads every fragment first, then
// issues its MMAs pass by pass (3xTF32: small.big, big.small, big.big), so
// that MT x NT independent MMAs separate two that add into the same
// accumulator; steps are not unrolled, which keeps one step's fragments
// live at a time.
template <bool BF, int MT, int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4], const float* a, int lda,
                                          const int (&ro)[MT][2], const float* b, int ldb,
                                          int K, int g, int t) {
  using F = Frag<BF>;
  const int k0 = BF ? 2 * t : t;   // this lane's first column of a step
  const float* ar[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    ar[i][0] = a + k0 * lda + ro[i][0];
    ar[i][1] = a + k0 * lda + ro[i][1];
  }
  const float* bc = b + g * ldb + k0;
#pragma unroll 1
  for (int k = 0; k < K; k += F::K) {
    uint32_t fa[MT][F::AR], fb[NT][F::BR];
#pragma unroll
    for (int i = 0; i < MT; ++i) load_a<BF>(fa[i], ar[i][0] + k * lda, ar[i][1] + k * lda, lda);
#pragma unroll
    for (int j = 0; j < NT; ++j) load_b<BF>(fb[j], bc + j * 8 * ldb + k);
    if constexpr (BF) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], fa[i], fb[j]);
    } else {
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_tf32(acc[i][j], fa[i] + (pass == 0 ? 4 : 0), fb[j] + (pass == 1 ? 2 : 0));
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Row strides in shared memory, in floats: the smallest v >= n with v % 32
// == rem. An A operand (lanes read t * ld + g) wants 8 or 24, so that the
// four column lanes fall in different banks; h2, written from accumulators
// (lanes write 2t * ld + g), wants v % 8 == 4.
constexpr int ld_rem(int n, int rem) { return n + ((rem - n % 32) % 32 + 32) % 32; }
constexpr int ld_a(int n) { return ld_rem(n, 8) < ld_rem(n, 24) ? ld_rem(n, 8) : ld_rem(n, 24); }
constexpr int ld_h(int n) { return n + ((4 - n % 8) % 8 + 8) % 8; }   // n % 8 == 4
constexpr int kLdW = KS + 4;    // W_exp (pool) and W_skip slabs, per row (lanes read g * ld + t)
constexpr int kLdWO = KSO + 4;  // W_exp slabs of the output pass, per row

// channels of x padded to whole slabs
__host__ __device__ __forceinline__ int cin_slabs(int cin) { return (cin + KS - 1) / KS; }

// Where column rx of a row of x goes in shared memory, from the row's start:
// rows of TW + 4 HALO floats with the interior columns on 16-byte boundaries
// (rx = 1 at 4), the left halo column before them (3) and the right one in
// the row's first free slot (2), so that a row ends where the next begins.
template <int HALO, int TW> __host__ __device__ constexpr int col_off(int rx) {
  return HALO && rx == TW + 1 ? 2 : rx + 3 * HALO;
}

// Copy channels k0 .. k0 + nk - 1 of image b's x over the RH x (TW + 2 HALO)
// pixels whose top-left corner is image pixel (gy0, gx0) into dst: region
// pixel (ry, rx) of channel k at dst[k * ld + ry * (TW + 4 HALO) +
// col_off(rx)]. Zero outside the image and for channels >= Cin. f32 x goes by
// cp.async (16-byte interior copies when vec), to be turned into x-hat by
// finish_x; bf16 x is loaded, widened and, given a1s, turned into x-hat here.
template <typename T, bool SILU, int HALO, int RH, int TW>
__device__ void stage_x(const Irb& p, int b, int gy0, int gx0, int k0, int nk, float* dst, int ld,
                        const float* a1s, const float* b1s) {
  constexpr int RW = TW + 2 * HALO, RS = TW + 4 * HALO;
  const size_t plane = static_cast<size_t>(p.H) * p.W;
  const T* xb = static_cast<const T*>(p.x) + static_cast<size_t>(b) * p.Cin * plane;
  if (sizeof(T) == 4 && p.vec_x) {
    constexpr int PC = TW / 4 + 2 * HALO;   // pieces a row: vectors, then the halo columns
    const float* xf = reinterpret_cast<const float*>(xb);
    const int items = nk * RH * PC;
    for (int i = threadIdx.x; i < items; i += kThreads) {
      const int pc = i % PC, ry = (i / PC) % RH, k = i / (PC * RH);
      const int gy = gy0 + ry;
      const bool row = gy >= 0 && gy < p.H && k0 + k < p.Cin;
      const float* src = xf + (row ? (k0 + k) * plane + static_cast<size_t>(gy) * p.W : 0);
      float* d = dst + k * ld + ry * RS;
      if (pc < TW / 4) {   // gx is a multiple of 4 and W too: all in or all out
        const int gx = gx0 + HALO + 4 * pc;
        const bool ok = row && gx < p.W;
        cp_async16(d + col_off<HALO, TW>(HALO + 4 * pc), ok ? src + gx : xf, ok);
      } else {
        const int rx = pc == TW / 4 ? 0 : RW - 1;
        const int gx = gx0 + rx;
        const bool ok = row && gx >= 0 && gx < p.W;
        cp_async4(d + col_off<HALO, TW>(rx), ok ? src + gx : xf, ok);
      }
    }
    return;
  }
  const int items = nk * RH * RW;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int rx = i % RW, ry = (i / RW) % RH, k = i / (RW * RH);
    const int gy = gy0 + ry, gx = gx0 + rx;
    const bool ok = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && k0 + k < p.Cin;
    const T* src = xb + (ok ? (k0 + k) * plane + static_cast<size_t>(gy) * p.W + gx : 0);
    float* d = dst + k * ld + ry * RS + col_off<HALO, TW>(rx);
    if constexpr (sizeof(T) == 4) {
      cp_async4(d, reinterpret_cast<const float*>(src), ok);
    } else {
      const float v = ok ? load_f32(src) : 0.f;
      *d = a1s ? act<SILU>(fmaf(a1s[k0 + k], v, b1s[k0 + k])) : v;
    }
  }
}

// x-hat = act(a1 * x + b1), in place, on the f32 elements this thread copied
// in stage_x with the same arguments (its cp.async groups waited for).
// Outside the image too: h2 is set to zero there later; channels >= Cin have
// a1 = b1 = 0 and stay 0.
template <typename T, bool SILU, int HALO, int RH, int TW>
__device__ void finish_x(const Irb& p, int k0, int nk, float* dst, int ld, const float* a1s,
                         const float* b1s) {
  if constexpr (sizeof(T) == 4) {
    constexpr int RW = TW + 2 * HALO, RS = TW + 4 * HALO;
    if (p.vec_x) {
      constexpr int PC = TW / 4 + 2 * HALO;
      const int items = nk * RH * PC;
      for (int i = threadIdx.x; i < items; i += kThreads) {
        const int pc = i % PC, ry = (i / PC) % RH, k = i / (PC * RH);
        const float a = a1s[k0 + k], c = b1s[k0 + k];
        float* d = dst + k * ld + ry * RS;
        if (pc < TW / 4) {
          float4* v = reinterpret_cast<float4*>(d + col_off<HALO, TW>(HALO + 4 * pc));
          float4 w = *v;
          w.x = act<SILU>(fmaf(a, w.x, c));
          w.y = act<SILU>(fmaf(a, w.y, c));
          w.z = act<SILU>(fmaf(a, w.z, c));
          w.w = act<SILU>(fmaf(a, w.w, c));
          *v = w;
        } else {
          float* v = d + col_off<HALO, TW>(pc == TW / 4 ? 0 : RW - 1);
          *v = act<SILU>(fmaf(a, *v, c));
        }
      }
    } else {
      const int items = nk * RH * RW;
      for (int i = threadIdx.x; i < items; i += kThreads) {
        const int rx = i % RW, ry = (i / RW) % RH, k = i / (RW * RH);
        float* v = dst + k * ld + ry * RS + col_off<HALO, TW>(rx);
        *v = act<SILU>(fmaf(a1s[k0 + k], *v, b1s[k0 + k]));
      }
    }
  }
}

// Rows r0 .. r0 + NR - 1, columns k0 .. k0 + NK - 1 of the row-major [R, K]
// matrix w into d[r][k] (row stride ld), by cp.async: 16-byte copies when
// vec (K and k0 multiples of 4, w aligned), zero outside the matrix.
template <int NR, int NK>
__device__ __forceinline__ void stage_w(float* d, int ld, const float* w, int R, int K, int r0,
                                        int k0, bool vec) {
  if (vec) {
    constexpr int Q = NK / 4;
    for (int i = threadIdx.x; i < NR * Q; i += kThreads) {
      const int r = i / Q, c = (i % Q) * 4;
      const bool ok = r0 + r < R && k0 + c < K;
      cp_async16(d + r * ld + c, ok ? w + static_cast<size_t>(r0 + r) * K + k0 + c : w, ok);
    }
  } else {
    for (int i = threadIdx.x; i < NR * NK; i += kThreads) {
      const int r = i / NK, c = i % NK;
      const bool ok = r0 + r < R && k0 + c < K;
      cp_async4(d + r * ld + c, ok ? w + static_cast<size_t>(r0 + r) * K + k0 + c : w, ok);
    }
  }
}

// A W_exp slab (NR rows of NK columns, rows NK + 4 apart in shared memory)
// through registers: loaded a stage
// ahead, kept in registers while the stage's products run, and stored to
// its ring slot after them, so that the loads' latency hides behind the
// products. For 16-byte rows (vec_wexp); otherwise the slab goes by
// cp.async with x (stage_w).
template <int NR, int NK> struct WRegs {
  static constexpr int Q = NK / 4, N = (NR * Q + kThreads - 1) / kThreads, LD = NK + 4;
  float4 v[N];
  __device__ __forceinline__ void load(const float* w, int R, int K, int r0, int k0) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * kThreads, r = i / Q, c = (i % Q) * 4;
      v[u] = i < NR * Q && r0 + r < R && k0 + c < K
                 ? __ldg(reinterpret_cast<const float4*>(w + static_cast<size_t>(r0 + r) * K +
                                                        k0 + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(float* d) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (NR * Q % kThreads == 0 || i < NR * Q)
        *reinterpret_cast<float4*>(d + (i / Q) * LD + (i % Q) * 4) = v[u];
    }
  }
};

template <int CO_PAD> struct OutLayout {
  using C = OutCfg<CO_PAD>;
  static constexpr int TH = C::TH, TW = C::TW, CC = C::CC;
  static constexpr int RH = TH + 2, RW = TW + 2, RS = TW + 4;  // region rows, columns, row stride
  static constexpr int RP = RH * RW;   // region pixels: the expand's rows
  static constexpr int P = TH * TW;    // tile pixels: the project's rows
  static constexpr int LDX = ld_a(RH * RS);        // x-hat, per channel (rows of RS)
  static constexpr int LDH = ld_h(RP);             // h2, per channel (rows of RW)
  static constexpr int LDQ = ld_a(P);              // h3 and the skip's x, per channel
  static constexpr int LDP = CC + 4;               // W_proj's chunk, per output channel
  // expand: MT_E m-tiles of 16 region pixels by CC / 8 n-tiles; project:
  // P / 16 by CO_PAD / 8. A warp takes EMT x ENT (PMT x PNT) of them.
  static constexpr int MT_E = (RP + 15) / 16, EWM = C::EWM, EWN = kWarps / EWM;
  static constexpr int EMT = (MT_E + EWM - 1) / EWM, ENT = CC / 8 / EWN;
  static constexpr int PWM = C::PWM, PWN = kWarps / PWM;
  static constexpr int PMT = P / 16 / PWM, PNT = CO_PAD / 8 / PWN;
  // shared memory, in floats, after x-hat: the W_exp ring (two slabs), h2
  // (then h3, then the skip's x slab),
  // W_proj's chunk (then a W_skip slab), the chunk's a2, b2, gate and
  // depthwise taps; then, streaming, a1 and b1 [Cin padded to slabs] (with
  // x-hat resident they are read only before the first h2, and sit in h2's
  // room). x-hat's region rows are RS apart (col_off), h2's RW apart.
  static constexpr int WSLAB = CC * kLdWO;  // a W_exp slab (KSO columns)
  static constexpr int RING = 2 * WSLAB;
  static constexpr int H2 = CC * LDH;
  static constexpr int WP = CO_PAD * LDP;
  static constexpr int FIXED = RING + H2 + WP + 12 * CC;
  static_assert(CC % 16 == 0 && (CC / 8) % EWN == 0, "hidden chunk");
  static_assert(P % 16 == 0 && (P / 16) % PWM == 0 && (CO_PAD / 8) % PWN == 0, "project tiles");
  static_assert(TW % 8 == 0, "depthwise segments of 8 pixels");
  static_assert(CC * LDQ <= H2 && KS * LDQ <= H2, "h3 and the skip's x fit in h2's room");
  static_assert(CO_PAD * kLdW <= WP, "a W_skip slab fits in W_proj's room");
};

// floats of shared memory the output pass takes, x-hat resident or not (0:
// x-hat cannot be resident, a1 and b1 would not fit in h2's room)
template <int CO_PAD> size_t out_floats(int cin, bool resident) {
  using L = OutLayout<CO_PAD>;
  const int cin_pad = cin_slabs(cin) * KS;
  if (resident) return 2 * cin_pad <= L::H2 ? static_cast<size_t>(cin_pad) * L::LDX + L::FIXED : 0;
  const int cin_stages = (cin_pad + KSO - 1) / KSO * KSO;   // a1, b1 for whole stages
  return static_cast<size_t>(2 * KSO) * L::LDX + L::FIXED + 2 * cin_stages;
}

template <typename T, bool BF, int CO_PAD, bool SILU>
__global__ void __launch_bounds__(kThreads, 1) irb_out(Irb p, int resident) {
  using L = OutLayout<CO_PAD>;
  constexpr int TH = L::TH, TW = L::TW, CC = L::CC, RW = L::RW, RS = L::RS;
  constexpr int LDX = L::LDX, LDH = L::LDH, LDQ = L::LDQ, LDP = L::LDP;
  extern __shared__ float4 smem4[];
  const int cin_pad = cin_slabs(p.Cin) * KS, nslab = (cin_pad + KSO - 1) / KSO;
  float* const xs = reinterpret_cast<float*>(smem4);   // x-hat: resident, or 2 slab slots
  float* const ring = xs + (resident ? cin_pad : 2 * KSO) * LDX;
  float* const h2s = ring + L::RING;   // h2 [CC][LDH]; then h3 [CC][LDQ]; then x [KS][LDQ]
  float* const wps = h2s + L::H2;      // W_proj [CO_PAD][LDP]; then W_skip [CO_PAD][kLdW]
  float* const a2s = wps + L::WP;
  float* const b2s = a2s + CC;
  float* const gts = b2s + CC;
  float* const wds = gts + CC;         // [CC][9]
  // a1, b1 [cin_pad], streaming for whole stages [nslab * KSO]
  const int n_ab = resident ? cin_pad : nslab * KSO;
  float* const a1s = resident ? h2s : wds + 9 * CC;
  float* const b1s = a1s + n_ab;
  float* const h3s = h2s;

  const int tiles_x = (p.W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  // blockIdx.y walks the hidden groups of each block of CO_PAD output
  // channels; only CO_PAD = 256 has more than one such block (Cout > 256)
  const int grp = blockIdx.y % p.groups, b = blockIdx.z;
  const int co_base = (blockIdx.y / p.groups) * CO_PAD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nchunks = (p.Chid + CC - 1) / CC;
  const int ch_begin = grp * p.chunks_per_group;
  const int ch_end = min(nchunks, ch_begin + p.chunks_per_group);
  const size_t plane = static_cast<size_t>(p.H) * p.W;

  // this lane's rows: expand (region pixels; clamped to pixel 0 past the
  // region, where nothing is kept), project (tile pixels)
  const int ewm = warp % L::EWM, ewn = warp / L::EWM;
  const int pwm = warp % L::PWM, pwn = warp / L::PWM;
  int ero[L::EMT][2], pro[L::PMT][2];
  bool ekeep[L::EMT][2], ein[L::EMT][2];
#pragma unroll
  for (int i = 0; i < L::EMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (ewm * L::EMT + i) * 16 + g + 8 * h;
      const int ry = m / RW, rx = m % RW, gy = y0 - 1 + ry, gx = x0 - 1 + rx;
      ekeep[i][h] = m < L::RP;
      ein[i][h] = m < L::RP && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      ero[i][h] = m < L::RP ? ry * RS + col_off<1, TW>(rx) : 3;
    }
#pragma unroll
  for (int i = 0; i < L::PMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) pro[i][h] = (pwm * L::PMT + i) * 16 + g + 8 * h;

  float pacc[L::PMT][L::PNT][4];
  float eacc[L::EMT][L::ENT][4];
  zero(pacc);
  zero(eacc);
  for (int i = tid; i < n_ab; i += kThreads) {
    const bool ok = i < p.Cin;
    a1s[i] = ok ? p.a1[static_cast<size_t>(b) * p.Cin + i] : 0.f;
    b1s[i] = ok ? p.b1[static_cast<size_t>(b) * p.Cin + i] : 0.f;
  }
  __syncthreads();

  // stage j: slab j % nslab of chunk ch_begin + j / nslab, in ring slot j % 2
  // (and, streaming, x's slab in x slot j % 2); resident x-hat goes with stage 0
  const int nstages = (ch_end - ch_begin) * nslab;
  auto issue = [&](int j) {
    const int c0 = (ch_begin + j / nslab) * CC, s = j % nslab;
    if (!resident)
      stage_x<T, SILU, 1, L::RH, TW>(p, b, y0 - 1, x0 - 1, s * KSO, KSO,
                                     xs + (j & 1) * KSO * LDX, LDX, a1s, b1s);
    else if (j == 0)
      stage_x<T, SILU, 1, L::RH, TW>(p, b, y0 - 1, x0 - 1, 0, cin_pad, xs, LDX, a1s, b1s);
    if (!p.vec_wexp)
      stage_w<CC, KSO>(ring + (j & 1) * L::WSLAB, kLdWO, p.wexp, p.Chid, p.Cin, c0, s * KSO,
                       false);
    cp_async_commit();
  };
  WRegs<CC, KSO> wr;   // stage j's W_exp slab, with 16-byte rows
  auto load_w = [&](int j) {
    if (p.vec_wexp) wr.load(p.wexp, p.Chid, p.Cin, (ch_begin + j / nslab) * CC, j % nslab * KSO);
  };
  auto store_w = [&](int j) {
    if (p.vec_wexp) wr.store(ring + (j & 1) * L::WSLAB);
  };

  load_w(0);
  store_w(0);
  issue(0);
  for (int j = 0; j < nstages; ++j) {
    const int s = j % nslab, c0 = (ch_begin + j / nslab) * CC;
    const bool more = j + 1 < nstages;
    if (s == 0) {
      // the chunk's a2, b2, gate and taps and its W_proj, copied while the
      // chunk's expand runs (zero past Chid)
      for (int i = tid; i < CC; i += kThreads) {
        const int c = c0 + i;
        const bool ok = c < p.Chid;
        const size_t bc = static_cast<size_t>(b) * p.Chid + (ok ? c : 0);
        cp_async4(a2s + i, p.a2 + bc, ok);
        cp_async4(b2s + i, p.b2 + bc, ok);
        if (p.gate)
          cp_async4(gts + i, p.gate + bc, ok);
        else
          gts[i] = ok ? 1.f : 0.f;
      }
      for (int i = tid; i < CC * 9; i += kThreads) {
        const bool ok = c0 + i / 9 < p.Chid;
        cp_async4(wds + i, p.wdw + (ok ? static_cast<size_t>(c0) * 9 + i : 0), ok);
      }
      stage_w<CO_PAD, CC>(wps, LDP, p.wproj, p.Cout, p.Chid, co_base, c0, p.vec_wproj);
      cp_async_commit();
    }
    if (more) {
      load_w(j + 1);
      issue(j + 1);
    }
    // stage j has landed once at most the groups issued after it are pending
    if (s == 0) {
      if (more) cp_async_wait<2>(); else cp_async_wait<1>();
    } else {
      if (more) cp_async_wait<1>(); else cp_async_wait<0>();
    }
    if (!resident)
      finish_x<T, SILU, 1, L::RH, TW>(p, s * KSO, KSO, xs + (j & 1) * KSO * LDX, LDX, a1s, b1s);
    else if (j == 0)
      finish_x<T, SILU, 1, L::RH, TW>(p, 0, cin_pad, xs, LDX, a1s, b1s);
    __syncthreads();

    // expand: h1 += x-hat (region pixels x slab) . W_exp (slab x chunk)
    const float* xa = xs + (resident ? s : (j & 1)) * KSO * LDX;
    warp_gemm<BF, L::EMT, L::ENT>(eacc, xa, LDX, ero,
                                  ring + (j & 1) * L::WSLAB + ewn * L::ENT * 8 * kLdWO, kLdWO,
                                  min(KSO, cin_pad - s * KSO), g, t);
    if (more) store_w(j + 1);   // its slot was last read before the previous barrier
    if (s == nslab - 1) {
      // the chunk's parameters and W_proj have landed once at most the next
      // stage is pending
      if (more) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      // h2 = act(a2 h1 + b2), zero outside the image, into h2s
#pragma unroll
      for (int i = 0; i < L::EMT; ++i)
#pragma unroll
        for (int jn = 0; jn < L::ENT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e / 2, n = (ewn * L::ENT + jn) * 8 + 2 * t + e % 2;
            const float v = ein[i][h] && c0 + n < p.Chid
                                ? act<SILU>(fmaf(a2s[n], eacc[i][jn][e], b2s[n]))
                                : 0.f;
            if (ekeep[i][h]) h2s[n * LDH + (ewm * L::EMT + i) * 16 + g + 8 * h] = v;
            eacc[i][jn][e] = 0.f;
          }
      __syncthreads();

      // depthwise 3x3 and gate, a thread item 8 consecutive pixels of a row;
      // h3 overwrites h2 once every thread has read it
      constexpr int NSEG = TW / 8, ITEMS = CC * TH * NSEG;
      constexpr int NIT = (ITEMS + kThreads - 1) / kThreads;
      float h3v[NIT][8];
#pragma unroll
      for (int u = 0; u < NIT; ++u) {
        const int it = tid + u * kThreads;
        if (ITEMS % kThreads == 0 || it < ITEMS) {
          const int sg = it % NSEG, y = (it / NSEG) % TH, c = it / (NSEG * TH);
          // region row y + dy, columns 8 sg .. 8 sg + 9 (image row y0 + y + dy - 1)
          const float* hrow = h2s + c * LDH + y * RW + sg * 8;
#pragma unroll
          for (int q = 0; q < 8; ++q) h3v[u][q] = 0.f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            float r[10];
#pragma unroll
            for (int q = 0; q < 10; ++q) r[q] = hrow[dy * RW + q];
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float w = wds[c * 9 + dy * 3 + dx];
#pragma unroll
              for (int q = 0; q < 8; ++q) h3v[u][q] = fmaf(w, r[q + dx], h3v[u][q]);
            }
          }
          const float gt = gts[c];
#pragma unroll
          for (int q = 0; q < 8; ++q) h3v[u][q] *= gt;
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < NIT; ++u) {
        const int it = tid + u * kThreads;
        if (ITEMS % kThreads == 0 || it < ITEMS) {
          const int sg = it % NSEG, y = (it / NSEG) % TH, c = it / (NSEG * TH);
          float4* dst = reinterpret_cast<float4*>(h3s + c * LDQ + y * TW + sg * 8);
          dst[0] = make_float4(h3v[u][0], h3v[u][1], h3v[u][2], h3v[u][3]);
          dst[1] = make_float4(h3v[u][4], h3v[u][5], h3v[u][6], h3v[u][7]);
        }
      }
      __syncthreads();

      // project: out += h3 (tile pixels x chunk) . W_proj (chunk x outputs)
      warp_gemm<BF, L::PMT, L::PNT>(pacc, h3s, LDQ, pro, wps + pwn * L::PNT * 8 * LDP, LDP, CC,
                                    g, t);
    }
    __syncthreads();   // ring slot j % 2 is free; after a chunk, h2s, wps and its parameters
  }

  if (grp == 0 && p.wskip) {   // out += x . W_skip, a slab of input channels at a time
    for (int s = 0; s < cin_pad / KS; ++s) {
      stage_x<T, SILU, 0, TH, TW>(p, b, y0, x0, s * KS, KS, h2s, LDQ, nullptr, nullptr);
      stage_w<CO_PAD, KS>(wps, kLdW, p.wskip, p.Cout, p.Cin, co_base, s * KS, p.vec_wskip);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      warp_gemm<BF, L::PMT, L::PNT>(pacc, h2s, LDQ, pro, wps + pwn * L::PNT * 8 * kLdW, kLdW, KS,
                                    g, t);
      __syncthreads();
    }
  }

  const T* xb = static_cast<const T*>(p.x) + static_cast<size_t>(b) * p.Cin * plane;
#pragma unroll
  for (int i = 0; i < L::PMT; ++i)
#pragma unroll
    for (int jn = 0; jn < L::PNT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = pro[i][e / 2];
        const int co = co_base + (pwn * L::PNT + jn) * 8 + 2 * t + e % 2;
        const int y = y0 + m / TW, x = x0 + m % TW;
        if (co >= p.Cout || y >= p.H || x >= p.W) continue;
        const size_t at = static_cast<size_t>(co) * plane + static_cast<size_t>(y) * p.W + x;
        float v = pacc[i][jn][e];
        if (grp == 0 && !p.wskip) v += load_f32(xb + at);  // identity residual (Cin == Cout)
        const size_t bo = static_cast<size_t>(b) * p.Cout * plane + at;
        if (p.groups == 1)
          store_from_f32(static_cast<T*>(p.out) + bo, v);
        else
          p.part[static_cast<size_t>(grp) * p.B * p.Cout * plane + bo] = v;
      }
}

struct PoolLayout {
  static constexpr int TH = kPoolTH, TW = kPoolTW, CC = kPoolCC, P = TH * TW;
  static constexpr int LDX = ld_a(P);
  static constexpr int MT = P / 16, EWM = 4, EWN = kWarps / EWM;
  static constexpr int EMT = MT / EWM, ENT = CC / 8 / EWN;
  static constexpr int HPB = CC * kPoolChunksMax;   // hidden channels a block takes at most
  // edge pixels of a border tile, per channel of a chunk: the first and
  // last image row (TW each), the first and last image column (TH each)
  static constexpr int EDGE = 2 * TW + 2 * TH;
  // shared memory, in floats, after x-hat: the W_exp ring, the warps' sums
  // [EWM][HPB][NF], and without STATS the edge sums [HPB][8] and the edge
  // pixels [CC][EDGE]; a2, b2 [HPB]; then a1, b1 [Cin padded to slabs]
  static constexpr int WSLAB = CC * kLdW;   // a W_exp slab
  static constexpr int RING = 2 * WSLAB;
  static_assert(MT % EWM == 0 && (CC / 8) % EWN == 0 && CC * 4 == kThreads, "pool tiles");
};

template <bool STATS> size_t pool_floats(int cin, bool resident) {
  using L = PoolLayout;
  const int cin_pad = cin_slabs(cin) * KS;
  return static_cast<size_t>(resident ? cin_pad : 2 * KS) * L::LDX + L::RING +
         L::EWM * L::HPB * (STATS ? 2 : 1) + (STATS ? 0 : L::HPB * 8 + L::CC * L::EDGE) +
         2 * L::HPB + 2 * cin_pad;
}

// SE pool partials (or, STATS, v1's GN2 statistics): per (batch, pixel
// group, hidden channel) the nine sums of h2 (the sums of h1 and h1^2) over
// the group's tiles, written to out [B, pool_groups, 9 (2), Chid]. A warp
// reduces its accumulators over its rows with shuffles and adds them to its
// own sums in shared memory; the warps' sums are added in a fixed order at
// the end. Only tiles on the image's border add the edge and corner sums:
// their edge pixels go to shared memory, and one thread per (channel, edge)
// sums them.
template <typename T, bool BF, bool STATS, bool SILU>
__global__ void __launch_bounds__(kThreads, 2) irb_pool(Irb p, float* out, int resident) {
  using L = PoolLayout;
  constexpr int TH = L::TH, TW = L::TW, CC = L::CC, LDX = L::LDX, NS = STATS ? 2 : 9;
  constexpr int NF = STATS ? 2 : 1;   // sums reduced from the accumulators
  extern __shared__ float4 smem4[];
  const int nslab = cin_slabs(p.Cin), cin_pad = nslab * KS;
  float* const xs = reinterpret_cast<float*>(smem4);
  float* const ring = xs + (resident ? cin_pad : 2 * KS) * LDX;
  float* const sums = ring + L::RING;                  // [EWM][HPB][NF]
  float* const edges = sums + L::EWM * L::HPB * NF;   // [HPB][8]
  float* const eb = edges + (STATS ? 0 : L::HPB * 8);  // [CC][EDGE]
  float* const a2s = eb + (STATS ? 0 : CC * L::EDGE);
  float* const b2s = a2s + L::HPB;
  float* const a1s = b2s + L::HPB;
  float* const b1s = a1s + cin_pad;

  const int tiles_x = (p.W + TW - 1) / TW;
  const int tiles = tiles_x * ((p.H + TH - 1) / TH);
  const int group = blockIdx.x, b = blockIdx.z;
  const int nchunks = (p.Chid + CC - 1) / CC;
  const int ch_begin = blockIdx.y * p.pool_chunks;
  const int nch = min(nchunks, ch_begin + p.pool_chunks) - ch_begin;
  const int hc0 = ch_begin * CC;   // the block's first hidden channel
  const int ntiles = group < tiles ? (tiles - group + p.pool_groups - 1) / p.pool_groups : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp % L::EWM, wn = warp / L::EWM;

  for (int i = tid; i < L::EWM * L::HPB * NF + (STATS ? 0 : L::HPB * 8); i += kThreads)
    sums[i] = 0.f;
  for (int i = tid; i < L::HPB; i += kThreads) {
    const int c = hc0 + i;
    const bool ok = !STATS && c < p.Chid && i < nch * CC;
    a2s[i] = ok ? p.a2[static_cast<size_t>(b) * p.Chid + c] : 0.f;
    b2s[i] = ok ? p.b2[static_cast<size_t>(b) * p.Chid + c] : 0.f;
  }
  for (int i = tid; i < cin_pad; i += kThreads) {
    const bool ok = i < p.Cin;
    a1s[i] = ok ? p.a1[static_cast<size_t>(b) * p.Cin + i] : 0.f;
    b1s[i] = ok ? p.b1[static_cast<size_t>(b) * p.Cin + i] : 0.f;
  }
  __syncthreads();

  int ro[L::EMT][2];
#pragma unroll
  for (int i = 0; i < L::EMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) ro[i][h] = (wm * L::EMT + i) * 16 + g + 8 * h;
  float acc[L::EMT][L::ENT][4];
  zero(acc);

  // stage j: tile j / per_tile of the group, chunk (j / nslab) % nch, slab
  // j % nslab; resident x-hat goes with a tile's first stage
  const int per_tile = nch * nslab, nstages = ntiles * per_tile;
  auto origin = [&](int j, int& ty0, int& tx0) {
    const int tile = group + (j / per_tile) * p.pool_groups;
    ty0 = (tile / tiles_x) * TH;
    tx0 = (tile % tiles_x) * TW;
  };
  auto issue = [&](int j) {
    const int s = j % nslab, c = (j / nslab) % nch;
    int ty0, tx0;
    origin(j, ty0, tx0);
    if (!resident)
      stage_x<T, SILU, 0, TH, TW>(p, b, ty0, tx0, s * KS, KS, xs + (j & 1) * KS * LDX, LDX, a1s,
                                  b1s);
    else if (j % per_tile == 0)
      stage_x<T, SILU, 0, TH, TW>(p, b, ty0, tx0, 0, cin_pad, xs, LDX, a1s, b1s);
    if (!p.vec_wexp)
      stage_w<CC, KS>(ring + (j & 1) * L::WSLAB, kLdW, p.wexp, p.Chid, p.Cin,
                      (ch_begin + c) * CC, s * KS, false);
    cp_async_commit();
  };
  WRegs<CC, KS> wr;   // stage j's W_exp slab, with 16-byte rows
  auto load_w = [&](int j) {
    if (p.vec_wexp)
      wr.load(p.wexp, p.Chid, p.Cin, (ch_begin + (j / nslab) % nch) * CC, j % nslab * KS);
  };
  auto store_w = [&](int j) {
    if (p.vec_wexp) wr.store(ring + (j & 1) * L::WSLAB);
  };

  if (nstages > 0) {
    load_w(0);
    store_w(0);
    issue(0);
  }
  for (int j = 0; j < nstages; ++j) {
    const int s = j % nslab, c = (j / nslab) % nch;
    // a resident tile's x-hat is replaced only after the last stage of the
    // tile before it: no prefetch across tiles then
    const bool pre = j + 1 < nstages && !(resident && (j + 1) % per_tile == 0);
    if (j + 1 < nstages) load_w(j + 1);
    if (pre) issue(j + 1);
    if (pre) cp_async_wait<1>(); else cp_async_wait<0>();
    if (!resident)
      finish_x<T, SILU, 0, TH, TW>(p, s * KS, KS, xs + (j & 1) * KS * LDX, LDX, a1s, b1s);
    else if (j % per_tile == 0)
      finish_x<T, SILU, 0, TH, TW>(p, 0, cin_pad, xs, LDX, a1s, b1s);
    __syncthreads();
    warp_gemm<BF, L::EMT, L::ENT>(acc, xs + (resident ? s : (j & 1)) * KS * LDX, LDX, ro,
                                  ring + (j & 1) * L::WSLAB + wn * L::ENT * 8 * kLdW, kLdW, KS,
                                  g, t);
    if (j + 1 < nstages) store_w(j + 1);   // its slot was last read before the last barrier
    if (s == nslab - 1) {
      int ty0, tx0;
      origin(j, ty0, tx0);
      const bool border = !STATS && (ty0 == 0 || tx0 == 0 || ty0 + TH >= p.H || tx0 + TW >= p.W);
#pragma unroll
      for (int jn = 0; jn < L::ENT; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = (wn * L::ENT + jn) * 8 + 2 * t + e;   // the chunk's channel
          const int nl = c * CC + cl;                          // the block's channel
          const bool live = hc0 + nl < p.Chid;
          float sm[NF];
#pragma unroll
          for (int k = 0; k < NF; ++k) sm[k] = 0.f;
#pragma unroll
          for (int i = 0; i < L::EMT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = ro[i][h], ly = m / TW, lx = m % TW, gy = ty0 + ly, gx = tx0 + lx;
              const bool in = live && gy < p.H && gx < p.W;
              const float v = acc[i][jn][e + 2 * h];
              if constexpr (STATS) {
                const float hv = in ? v : 0.f;
                sm[0] += hv;
                sm[1] = fmaf(hv, hv, sm[1]);
              } else {
                const float hv = in ? act<SILU>(fmaf(a2s[nl], v, b2s[nl])) : 0.f;
                sm[0] += hv;
                if (border && in) {   // keep the edge pixels
                  float* ec = eb + cl * L::EDGE;
                  if (gy == 0) ec[lx] = hv;
                  if (gy == p.H - 1) ec[TW + lx] = hv;
                  if (gx == 0) ec[2 * TW + ly] = hv;
                  if (gx == p.W - 1) ec[2 * TW + TH + ly] = hv;
                }
              }
            }
          // over the warp's 8 row groups (lanes with the same t)
#pragma unroll
          for (int k = 0; k < NF; ++k)
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) sm[k] += __shfl_xor_sync(0xffffffffu, sm[k], m);
          if (g == 0)
#pragma unroll
            for (int k = 0; k < NF; ++k) sums[(wm * L::HPB + nl) * NF + k] += sm[k];
        }
      if constexpr (!STATS) {
        if (border) {   // the same for the whole block
          __syncthreads();
          // thread (cl, q): q = 0 the first row and its corners, 1 the last
          // row and its corners, 2 the first column, 3 the last column
          const int cl = tid / 4, q = tid % 4, nl = c * CC + cl;
          const int rows = min(TH, p.H - ty0), cols = min(TW, p.W - tx0);
          const bool on[4] = {ty0 == 0, ty0 + rows == p.H, tx0 == 0, tx0 + cols == p.W};
          if (hc0 + nl < p.Chid && on[q]) {
            const float* ec = eb + cl * L::EDGE + (q < 2 ? q * TW : 2 * TW + (q - 2) * TH);
            const int n = q < 2 ? cols : rows;
            float v = 0.f;
            for (int u = 0; u < n; ++u) v += ec[u];
            float* ed = edges + nl * 8;   // sums 1 .. 8 of the nine
            ed[q] += v;
            if (q < 2) {   // corners: (row, first column), (row, last column)
              if (on[2]) ed[4 + 2 * q] += ec[0];
              if (on[3]) ed[5 + 2 * q] += ec[cols - 1];
            }
          }
          __syncthreads();
        }
      }
      zero(acc);
    }
    __syncthreads();
    if (j + 1 < nstages && !pre) issue(j + 1);
  }

  for (int i = tid; i < nch * CC * NS; i += kThreads) {
    const int nl = i / NS, k = i % NS, c = hc0 + nl;
    if (c >= p.Chid) continue;
    float v = 0.f;
    if (k < NF) {
#pragma unroll
      for (int w = 0; w < L::EWM; ++w) v += sums[(w * L::HPB + nl) * NF + k];
    } else {
      v = edges[nl * 8 + k - 1];
    }
    out[(static_cast<size_t>(b) * p.pool_groups + group) * NS * p.Chid +
        static_cast<size_t>(k) * p.Chid + c] = v;
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

template <typename T, bool BF, int CO_PAD>
cudaError_t launch_out(const Irb& p, const int* dim, cudaStream_t st) {
  using L = OutLayout<CO_PAD>;
  if (dim[kTileH] != L::TH || dim[kTileW] != L::TW || dim[kChunk] != L::CC)
    return cudaErrorInvalidValue;  // the wrapper's tile table disagrees with this build
  const size_t res_floats = out_floats<CO_PAD>(p.Cin, true);
  const int resident = res_floats > 0 && sizeof(float) * res_floats <= kSmemMax;
  const size_t smem = sizeof(float) * out_floats<CO_PAD>(p.Cin, resident);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = p.silu ? allow_smem<irb_out<T, BF, CO_PAD, true>>(smem)
                           : allow_smem<irb_out<T, BF, CO_PAD, false>>(smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((p.H + L::TH - 1) / L::TH) * ((p.W + L::TW - 1) / L::TW);
  const int co_blocks = (p.Cout + CO_PAD - 1) / CO_PAD;
  if (p.groups * co_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(tiles, p.groups * co_blocks, p.B);
  if (p.silu)
    irb_out<T, BF, CO_PAD, true><<<grid, kThreads, smem, st>>>(p, resident);
  else
    irb_out<T, BF, CO_PAD, false><<<grid, kThreads, smem, st>>>(p, resident);
  return cudaGetLastError();
}

// The pool pass (STATS: v1's GN2 statistics) into out.
template <typename T, bool BF, bool STATS>
cudaError_t launch_pool(const Irb& p, float* out, cudaStream_t st) {
  const int resident = sizeof(float) * pool_floats<STATS>(p.Cin, true) <= kSmemMax;
  const size_t smem = sizeof(float) * pool_floats<STATS>(p.Cin, resident);
  if (smem > kSmemMax || p.pool_chunks <= 0 || p.pool_chunks > kPoolChunksMax)
    return cudaErrorInvalidValue;
  cudaError_t err = p.silu ? allow_smem<irb_pool<T, BF, STATS, true>>(smem)
                           : allow_smem<irb_pool<T, BF, STATS, false>>(smem);
  if (err != cudaSuccess) return err;
  const int nchunks = (p.Chid + kPoolCC - 1) / kPoolCC;
  const dim3 grid(p.pool_groups, (nchunks + p.pool_chunks - 1) / p.pool_chunks, p.B);
  if (p.silu)
    irb_pool<T, BF, STATS, true><<<grid, kThreads, smem, st>>>(p, out, resident);
  else
    irb_pool<T, BF, STATS, false><<<grid, kThreads, smem, st>>>(p, out, resident);
  return cudaGetLastError();
}

// The Irb of an entry point's arrays; false if they cannot describe an IRB.
template <typename T>
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
  p.pool_chunks = dim[kPoolChunks];
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
  // 16-byte copies where rows and pointers allow them
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  p.vec_x = sizeof(T) == 4 && p.W % 4 == 0 && aligned(p.x);
  p.vec_wexp = p.Cin % 4 == 0 && aligned(p.wexp);
  p.vec_wproj = p.Chid % 4 == 0 && aligned(p.wproj);
  p.vec_wskip = p.Cin % 4 == 0 && aligned(p.wskip);
  return true;
}

// Everything after the norms' affines: the SE pool and gate, the output
// pass and the combine. BF: bf16 products (v2's bf16 entry), else 3xTF32.
template <typename T, bool BF>
cudaError_t launch_irb(const Irb& p, const int* dim, cudaStream_t st) {
  cudaError_t err;
  if (p.gate) {
    err = launch_pool<T, BF, false>(p, p.pool, st);
    if (err != cudaSuccess) return err;
    irb_pooled<<<dim3((p.Chid + 31) / 32, p.B), kThreads, 0, st>>>(p);
    irb_se_fc1<<<dim3((p.Csq + kWarps - 1) / kWarps, p.B), kThreads, 0, st>>>(p);
    irb_se_fc2<<<dim3((p.Chid + kWarps - 1) / kWarps, p.B), kThreads, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const int co_pad = p.Cout <= 32 ? 32 : p.Cout <= 64 ? 64 : p.Cout <= 128 ? 128 : 256;
  switch (co_pad) {
    case 32: err = launch_out<T, BF, 32>(p, dim, st); break;
    case 64: err = launch_out<T, BF, 64>(p, dim, st); break;
    case 128: err = launch_out<T, BF, 128>(p, dim, st); break;
    default: err = launch_out<T, BF, 256>(p, dim, st); break;
  }
  if (err != cudaSuccess || p.groups == 1) return err;
  const size_t n = static_cast<size_t>(p.B) * p.Cout * p.H * p.W;
  const size_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 2048 ? want : 2048);
  irb_combine<T><<<blocks, kThreads, 0, st>>>(p.part, static_cast<T*>(p.out), n, p.groups);
  return cudaGetLastError();
}

// v2: the affines arrive folded; bf16 products on its bf16 entry.
template <typename T>
cudaError_t run_v2(const void* const* ptr, const int* dim, void* stream) {
  Irb p;
  if (!parse<T>(ptr, dim, p)) return cudaErrorInvalidValue;
  return launch_irb<T, sizeof(T) == 2>(p, dim, static_cast<cudaStream_t>(stream));
}

// v1: the norms' statistics and affines first, written into the a1, b1,
// a2, b2 arrays, then the same passes, with f32 operands in every product.
template <typename T>
cudaError_t run_v1(const void* const* ptr, const int* dim, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Irb p;
  if (!parse<T>(ptr, dim, p)) return cudaErrorInvalidValue;
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
  cudaError_t err = launch_pool<T, false, true>(p, n.stats2, st);
  if (err != cudaSuccess) return err;
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
