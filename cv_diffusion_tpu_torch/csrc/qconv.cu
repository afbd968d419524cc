// Exact int8 convolutions for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// They replace what the JAX package's QConv runs on its int8 path
// (cv_diffusion_tpu/ops/qconv.py:145-176): XLA's int8 conv_general_dilated
// with preferred_element_type=int32 (:104-110, 174). That is not a Pallas
// kernel, so no TPU kernel is ported here; the port needs a kernel all the
// same, because PyTorch has no int8 convolution on the card and a float32
// convolution of int8 values is not exact once a partial sum passes 2^24
// (a product is at most 127^2 = 16,129; the small UNet's widest 1x1 has
// K = 2,048 and its 3x3 Up/Downsample convs K = 2,304). Four entries, each
// equal to its plain PyTorch version (cv_diffusion_tpu_torch/ops/qconv.py)
// bit for bit, each but the weight pass for float32 and bfloat16 compute:
//
//   qconv_quantize_weight_f32
//                      the weight half of JAX's quantize (:169-172), which
//                      XLA fuses into the jitted call and the port runs on
//                      every call too: w [O, I, K, K] float32 -> s_w [O] =
//                      max(absmax_o * float(1/127), 1e-12) and q = clip(
//                      rint(w / s_w), -127, 127) in the layout the
//                      convolution reads, [O, K, K, Cp] or (depthwise) [9,
//                      Cp], zero-padded; one launch in place of ten small
//                      PyTorch kernels.
//   qconv_quantize_*   the input half (:163-168): x [N, C, H, W] -> int8
//                      [N, H, W, Cp], Cp = C rounded up to a multiple of 32
//                      (kChannelMultiple; the padding channels 0): q =
//                      clip(rint(x / s_x), -127, 127), s_x = max(amax, 1e-6)
//                      * float(1/127). The product needs the channel (K)
//                      axis contiguous, so the NCHW -> NHWC transpose is done
//                      in the same pass, in registers.
//   qconv_dense_*      1x1 and 3x3, stride 1 or 2, zero padding `pad`:
//                      acc[n, o, p] = sum over taps and channels of
//                      xq * wq, wq laid out [O, K, K, Cp].
//   qconv_depthwise_*  3x3 depthwise, stride 1 or 2, padding 1, wq [9, Cp].
//
// Both convolutions sum in int32, exactly and so in any order (|acc| <=
// 2,304 * 127^2 < 2^31), and apply the epilogue of the plain version in its
// order: y = float(acc) * (s_x * s_w[o]), the scale product formed first,
// rounded to the compute dtype, then + bias in that dtype. Every multiply
// and add is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn): nvcc
// would otherwise contract y * s + b into one FMA, which rounds once where
// PyTorch rounds twice. The divide is __fdiv_rn and the rounding rintf (half
// to even); the file is built without --use_fast_math. s_x is computed from
// the device scalar amax in every thread that needs it, the same way, so no
// host sync is needed and the sampler's CUDA graph captures the path.
//
// What bounds them on an H100 SXM (3.35 TB/s; 1,979 dense int8 TOP/s on the
// tensor cores). The dense entry is an implicit GEMM, M = N * OH * OW
// pixels, N = O channels, K = taps * Cp: at the small UNet's shapes its
// products need under a seventh of the time its bytes do (chip_smoke.py's
// qconv_work), and its bytes are above all the float32 NCHW output. So:
//  - the products run on the tensor cores (mma.sync m16n8k32 s8, int32
//    accumulators), fed by ldmatrix from a shared-memory ring whose 16-byte
//    chunks are swizzled so that eight rows of one chunk column fall in
//    eight different bank groups;
//  - the operands arrive by 16-byte cp.async, kStages stages of a 64-byte K
//    step in flight: both layouts are K-major (xq pixel-major, wq [O, kh,
//    kw, Cp]), so a chunk is 16 contiguous bytes of one tap, zero-filled
//    where a tap falls in the padding; the taps of a 3x3 are nine K steps
//    over the same input rows, which the ring reaches in L2, not in device
//    memory nine times over;
//  - the epilogue stages the tile in shared memory, transposed, so that a
//    warp stores 512 contiguous bytes of one output channel, 16 a thread;
//  - a per-shape plan (ops/qconv_kernel.py::plan_dense) picks the largest
//    of four tiles that still gives a wave of blocks. (Splitting K where the
//    tiles do not fill the 132 SMs was measured slower at every small-UNet
//    shape, its zeroed workspace and atomics included, and is not done.)
// The depthwise entry does 9 products a byte it reads and is bound by
// bytes, again above all its output's. A block takes 32 channels (one
// 32-byte run of each pixel) of a band of output rows of one image: it
// stages the band's input rows with their halo in shared memory by 16-byte
// copies along channels (two neighbouring threads, one pixel's 32 bytes), so
// each input byte comes from device memory once per band and each of the
// nine taps from shared memory, pixels rotated within groups of 4 so that a
// warp's reads fall in distinct banks; a thread then takes 4 channels of 4
// neighbouring output pixels, with the slab's weights in registers, and
// stores each channel's 4 pixels at once, 16 bytes of float32: a warp writes
// whole 32-byte sectors along pixels, in NCHW, with no staging of the output
// (ops/qconv_kernel.py::plan_depthwise sizes the band).
// Both quantize entries read their input once and write their output once,
// and are bound by bytes: 5 bytes an element in float32, 3 in bf16. One
// __fdiv_rn, rintf and clamp an element is ~15 instructions, under the ~45
// of issue the bytes' time leaves, but __fdiv_rn ends in a branch to its
// slow path, so one lane's divisions run one after another, and its range
// check takes a zero dividend down that slow path: after ReLU6 about half
// the activations are zeros. So the activations' design: a warp takes one
// 32-channel slab of 32 pixels; a lane 32 elements, 8 (float32) or 4 (bf16)
// channels of one 16-byte vector of pixels, whose loads it issues before it
// uses any (a warp's load is 4 or 8 runs of 128 or 64 bytes of channel
// rows); it quantizes them in registers (a zero is not divided: it is 0)
// and stores each pixel's 8 or 4 channels as one word packed with prmt
// (__byte_perm), so the 4 or 8 lanes of a pixel write its whole 32-byte
// sector: no shared memory, and many short lanes in flight, which a batch-1
// 32^2 input (64 blocks or more) needs as much as a batch-8 256^2 one
// (tens of thousands). Rows that are not 16-byte aligned (HW % V != 0, or
// x offset) take the same path with element loads. The weight pass reads
// 4 bytes and writes 1 an element, 72 MB at most (the student's 18,008,035
// parameters), each read once; launch latency dominates it (83 launches a
// UNet call, at most 2,048 blocks each). No Pallas kernel is replaced by
// any of the four.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInv127 = 1.0f / 127.0f;   // float(1/127), as JAX's compiled scales
constexpr float kActFloor = 1e-6f;
constexpr int kChannelMultiple = 32;       // ops/qconv.py CHANNEL_MULTIPLE
constexpr float kWeightFloor = 1e-12f;
// the activation quantize: 4 warps a block, each its own tile of one
// 32-channel slab x kQuantizeTile pixels; a lane kQuantizeLaneElems elements
// (one 16-byte vector of pixels of each of its channels)
constexpr int kQuantizeThreads = 128;
constexpr int kQuantizeLaneElems = 32;
constexpr int kQuantizeTile = kQuantizeLaneElems;   // 32 lanes' elements over 32 channels
// the weight pass: a block an output channel (dense) or 8 slabs (depthwise)
constexpr int kWeightThreads = 256;

__device__ __forceinline__ float act_scale(const float* amax) {
  return __fmul_rn(fmaxf(*amax, kActFloor), kInv127);
}

// clip(rint(x / s), -127, 127) for s > 0: an IEEE division, half to even.
// A zero x quantizes to 0 and is not divided: __fdiv_rn's range check sends
// a zero dividend down its slow path, and the activations after ReLU6 are
// about half zeros.
__device__ __forceinline__ signed char quantize_one(float x, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x == 0.0f ? s : x, s)), -127.0f), 127.0f);
  return x == 0.0f ? 0 : static_cast<signed char>(__float2int_rn(q));
}

// float(acc) * scale, rounded to the output dtype, then + bias in that dtype
__device__ __forceinline__ float dequant(int acc, float scale, const float* bias, int c) {
  float y = __fmul_rn(__int2float_rn(acc), scale);
  if (bias != nullptr) y = __fadd_rn(y, bias[c]);
  return y;
}

__device__ __forceinline__ __nv_bfloat16 dequant(int acc, float scale, const __nv_bfloat16* bias,
                                                 int c) {
  __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), scale));
  if (bias != nullptr) y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), __bfloat162float(bias[c])));
  return y;
}

// Inline PTX: every instruction this file uses beyond plain C++.

// Asynchronous 16-byte copy from device to shared memory; with valid false
// the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 16-byte matrices from shared memory: lanes 8q .. 8q + 7 give the
// rows of matrix q, and each lane receives, of matrix q, the 4 bytes
// 4 * (lane % 4) .. + 3 of its row lane / 4 in r[q].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t* b) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// End of inline PTX.

// --- the quantize entries: activations and weights ---------------------------

// Word i of a 16-byte vector (i known at compile time once unrolled).
__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Element e of 16 bytes of T held as raw bits, as float32 (exact: a bf16 is
// the upper half of its float32).
template <typename T>
__device__ __forceinline__ float element(const uint4& u, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(u, e));
  } else {
    const uint32_t w = word(u, e >> 1);
    return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
  }
}

// The raw bits of one element of T, in the low bits of a word.
template <typename T>
__device__ __forceinline__ uint32_t raw_bits(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(*reinterpret_cast<const float*>(p));
  } else {
    return *reinterpret_cast<const unsigned short*>(p);
  }
}

// Four int8 values (as ints) in one word, the first at the lowest address.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Stores the LC quantized channels of one pixel, LC bytes at dst.
template <int LC>
__device__ __forceinline__ void store_channels(signed char* dst, const uint32_t (&w)[LC / 4]) {
  if constexpr (LC == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

// A warp's tile: one 32-channel slab of Cp x kQuantizeTile pixels. A lane
// takes kQuantizeLaneElems elements: LC = 32 / V channels (8 float32, 4 bf16)
// of one 16-byte vector of V pixels (V = 16 / sizeof(T): 4 float32, 8 bf16).
// Lane l: channels LC (l % S) .. + LC - 1 of the slab, S = 32 / LC lanes to a
// pixel's 32-byte sector, at pixels V (l / S) .. + V - 1 of the tile. It
// issues its LC 16-byte loads, one a channel row, before it uses any (a
// warp's load: S rows of 32 / S lanes x 16 contiguous bytes), holds LC
// channels x V pixels in registers, and stores each pixel's LC channels as
// one LC-byte word packed with prmt, so the S lanes of a pixel write its
// whole 32-byte sector: no shared memory. Channels past C load nothing and
// store 0, the padding, without arithmetic. Where a channel row is not
// 16-byte aligned (vec false: HW % V != 0, or x offset) the same block is
// loaded element by element.
// grid ceil(units / 4), units = N * (Cp / 32) * chunks, chunks = ceil(HW /
// kQuantizeTile); block 128, warp w of block b takes unit 4b + w, ordered
// (n, slab, chunk), chunk fastest.
template <typename T>
__global__ void __launch_bounds__(kQuantizeThreads)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ amax,
                    signed char* __restrict__ out, int N, int C, int HW, int Cp, int chunks,
                    bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int LC = kQuantizeLaneElems / V, S = kChannelMultiple / LC;
  static_assert(V * (32 / S) == kQuantizeTile, "a warp's lanes cover its tile");
  const int lane = threadIdx.x & 31;
  const long long unit =
      static_cast<long long>(blockIdx.x) * (kQuantizeThreads / 32) + (threadIdx.x >> 5);
  const int slabs = Cp / kChannelMultiple;
  if (unit >= static_cast<long long>(N) * slabs * chunks) return;
  const int chunk = static_cast<int>(unit % chunks);
  const int slab = static_cast<int>(unit / chunks % slabs);
  const int n = static_cast<int>(unit / chunks / slabs);
  const int c0 = slab * kChannelMultiple + LC * (lane % S);
  const int p0 = chunk * kQuantizeTile + V * (lane / S);
  if (p0 >= HW) return;
  const T* src = x + (static_cast<size_t>(n) * C + c0) * HW + p0;
  uint4 u[LC];
#pragma unroll
  for (int i = 0; i < LC; ++i) {
    u[i] = make_uint4(0u, 0u, 0u, 0u);
    if (c0 + i >= C) continue;
    const T* row = src + static_cast<size_t>(i) * HW;
    if (vec) {
      u[i] = *reinterpret_cast<const uint4*>(row);
    } else {
      uint32_t b[V];
#pragma unroll
      for (int j = 0; j < V; ++j) b[j] = p0 + j < HW ? raw_bits(row + j) : 0u;
      if constexpr (V == 4) {
        u[i] = make_uint4(b[0], b[1], b[2], b[3]);
      } else {
        u[i] = make_uint4(b[0] | b[1] << 16, b[2] | b[3] << 16, b[4] | b[5] << 16,
                          b[6] | b[7] << 16);
      }
    }
  }
  const float s = act_scale(amax);
  signed char* dst = out + (static_cast<size_t>(n) * HW + p0) * Cp + c0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (p0 + j >= HW) break;
    uint32_t w[LC / 4];
#pragma unroll
    for (int k = 0; k < LC / 4; ++k)
      w[k] = c0 + 4 * k >= C ? 0u
                             : pack4(quantize_one(element<T>(u[4 * k], j), s),
                                     quantize_one(element<T>(u[4 * k + 1], j), s),
                                     quantize_one(element<T>(u[4 * k + 2], j), s),
                                     quantize_one(element<T>(u[4 * k + 3], j), s));
    store_channels<LC>(dst + static_cast<size_t>(j) * Cp, w);
  }
}

// The weights of one QConv: s_w[o] = max(absmax_o * float(1/127), 1e-12)
// over the I * KK values of output channel o, and q = clip(rint(w / s_w[o]),
// -127, 127) written in the layout the convolution reads, zero-padded to Cp.
// Dense (kDepthwise false), w [O, I, KK] -> [O, KK, Cp]: a block an output
// channel; its threads take the row's max |w| along the row (coalesced),
// reduce it by shuffles and through shared memory, then write the layout in
// words of 4 channels of one tap, a warp 128 contiguous bytes a step,
// reading the row again (from L1) at stride KK. Depthwise, w [O, 1, 9] ->
// [9, Cp]: a warp a slab of 32 channels (warp v of block b the slab 8b +
// v), a lane a channel: its 9 weights, their max and its 9 values, each
// tap a 32-byte run of the warp.
template <bool kDepthwise>
__global__ void __launch_bounds__(kWeightThreads)
    quantize_weight_kernel(const float* __restrict__ w, float* __restrict__ s_w,
                           signed char* __restrict__ out, int O, int I, int KK, int Cp) {
  const int lane = threadIdx.x & 31;
  if constexpr (kDepthwise) {
    const int o = (blockIdx.x * (kWeightThreads / 32) + (threadIdx.x >> 5)) * 32 + lane;
    if (o >= Cp) return;
    float v[9], m = 0.0f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      v[t] = o < O ? w[static_cast<size_t>(o) * 9 + t] : 0.0f;
      m = fmaxf(m, fabsf(v[t]));
    }
    const float s = fmaxf(__fmul_rn(m, kInv127), kWeightFloor);
    if (o < O) s_w[o] = s;
#pragma unroll
    for (int t = 0; t < 9; ++t) out[static_cast<size_t>(t) * Cp + o] = quantize_one(v[t], s);
  } else {
    __shared__ float part[kWeightThreads / 32];
    const int o = blockIdx.x;
    const int R = I * KK;
    const float* row = w + static_cast<size_t>(o) * R;
    float m = 0.0f;
#pragma unroll 4
    for (int e = threadIdx.x; e < R; e += kWeightThreads) m = fmaxf(m, fabsf(row[e]));
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (lane == 0) part[threadIdx.x >> 5] = m;
    __syncthreads();
#pragma unroll
    for (int v = 0; v < kWeightThreads / 32; ++v) m = fmaxf(m, part[v]);
    const float s = fmaxf(__fmul_rn(m, kInv127), kWeightFloor);
    if (threadIdx.x == 0) s_w[o] = s;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + static_cast<size_t>(o) * KK * Cp);
    const int words = KK * Cp / 4;
    for (int i = threadIdx.x; i < words; i += kWeightThreads) {
      const int t = 4 * i / Cp, c = 4 * i - t * Cp;
      int q[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) q[l] = c + l < I ? quantize_one(row[(c + l) * KK + t], s) : 0;
      dst[i] = pack4(q[0], q[1], q[2], q[3]);
    }
  }
}

// --- the dense entry: implicit GEMM on the tensor cores ----------------------

constexpr int kBK = 64;       // bytes of K a pipeline stage: two m16n8k32 steps
constexpr int kStages = 4;    // stages of the cp.async ring

// A tile of BM pixels x BN output channels, WM x WN warps; these four are
// ops/qconv_kernel.py's DENSE_TILES, in order.
template <int BM_, int BN_, int WM_, int WN_>
struct DenseTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kMT = BM / WM / 16;   // m16 tiles a warp
  static constexpr int kNT = BN / WN / 8;    // n8 tiles a warp
  static constexpr int kStageBytes = (BM + BN) * kBK;
  static_assert(kMT >= 1 && kNT >= 1 && (BM * 4) % kThreads == 0 && (BN * 4) % kThreads == 0,
                "tile shape");
  // the epilogue's [BN][BM + pad] tile of the output dtype, rows 16-byte aligned
  template <typename T> __host__ __device__ static constexpr int out_stride() {
    return BM + 16 / sizeof(T);
  }
  template <typename T> __host__ __device__ static constexpr int smem_bytes() {
    return kStages * kStageBytes > BN * out_stride<T>() * static_cast<int>(sizeof(T))
               ? kStages * kStageBytes
               : BN * out_stride<T>() * static_cast<int>(sizeof(T));
  }
};
using Tile0 = DenseTile<128, 128, 2, 4>;
using Tile1 = DenseTile<128, 64, 2, 2>;
using Tile2 = DenseTile<64, 64, 2, 2>;
using Tile3 = DenseTile<128, 32, 4, 1>;

// The byte offset of 16-byte chunk `chunk` of row `row` in a ring tile of
// 64-byte rows: rows 2j and 2j + 1 share a bank group pattern, so the chunk
// is XORed with (row / 2) % 4, and ldmatrix's eight rows of one chunk
// column fall in eight different 16-byte bank groups.
__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * kBK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// grid (ceil(M / BM), ceil(O / BN))
template <typename T, typename Tile>
__global__ void __launch_bounds__(Tile::kThreads)
    dense_kernel(const signed char* __restrict__ xq, const signed char* __restrict__ wq,
                 const float* __restrict__ amax, const float* __restrict__ s_w,
                 const T* __restrict__ bias, T* __restrict__ out, int N, int H, int W, int Cp,
                 int O, int KS, int stride, int pad, int OH, int OW) {
  constexpr int BM = Tile::BM, BN = Tile::BN, THREADS = Tile::kThreads;
  constexpr int MT = Tile::kMT, NT = Tile::kNT;
  constexpr int A_PER = BM * 4 / THREADS, B_PER = BN * 4 / THREADS, ROW_STEP = THREADS / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp % Tile::WM) * (BM / Tile::WM), wn0 = (warp / Tile::WM) * (BN / Tile::WN);
  const int P = OH * OW, M = N * P, Ktot = KS * KS * Cp;
  const int m0 = blockIdx.x * BM, o0 = blockIdx.y * BN, steps = (Ktot + kBK - 1) / kBK;

  // the loader: 16-byte chunk `lc` of rows tid / 4 + i * ROW_STEP of both tiles
  const int lc = tid & 3, lr = tid >> 2;
  int a_pix[A_PER], a_ih[A_PER], a_iw[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int m = m0 + lr + i * ROW_STEP;
    const int n = m / P, p = m - n * P, oh = p / OW, ow = p - oh * OW;
    a_pix[i] = n * H * W;
    a_ih[i] = m < M ? oh * stride - pad : -64;   // a row past M reads nothing
    a_iw[i] = ow * stride - pad;
  }
  auto load_stage = [&](int slot, int kt) {
    const int k = kt * kBK + lc * 16;
    const bool k_ok = k < Ktot;
    const int tap = k / Cp, c = k - tap * Cp, kh = tap / KS, kw = tap - kh * KS;
    unsigned char* sa = smem + slot * Tile::kStageBytes;
    unsigned char* sb = sa + BM * kBK;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int r = lr + i * ROW_STEP, ih = a_ih[i] + kh, iw = a_iw[i] + kw;
      const bool ok = k_ok && ih >= 0 && ih < H && iw >= 0 && iw < W;
      const signed char* src =
          ok ? xq + static_cast<size_t>(a_pix[i] + ih * W + iw) * Cp + c : xq;
      cp_async16(sa + swizzle(r, lc), src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int r = lr + i * ROW_STEP, o = o0 + r;
      const bool ok = k_ok && o < O;
      cp_async16(sb + swizzle(r, lc), ok ? wq + static_cast<size_t>(o) * Ktot + k : wq, ok);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step t has landed for all; slot (t - 1) % kStages is free
    if (t + kStages - 1 < steps) load_stage((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async_commit();
    const unsigned char* sa = smem + (t % kStages) * Tile::kStageBytes;
    const unsigned char* sb = sa + BM * kBK;
    uint32_t bf[NT][4];   // [nt]: b0, b1 of K bytes 0-31, then of 32-63
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = wn0 + j * 8 + (lane & 7);
      ldmatrix_x4(bf[j], sb + swizzle(row, lane >> 3));
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t af[4];   // rows 0-7 and 8-15 of K bytes 0-15, then of 16-31
        const int row = wm0 + i * 16 + (lane & 15);
        ldmatrix_x4(af, sa + swizzle(row, 2 * ks + (lane >> 4)));
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af, &bf[j][2 * ks]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the epilogue

  // lane's accumulator e of tile (i, j): pixel row wm0 + 16i + lane / 4 (+ 8
  // for e >= 2), channel column wn0 + 8j + 2 (lane % 4) + e % 2
  const int er = lane >> 2, ec = 2 * (lane & 3);

  // the epilogue into a [BN][BM] tile of T, then out along pixels
  constexpr int OS = Tile::template out_stride<T>();
  T* so = reinterpret_cast<T*>(smem);
  const float s = act_scale(amax);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = wn0 + j * 8 + ec + h, o = o0 + col;
      if (o >= O) continue;
      const float scale = __fmul_rn(s, s_w[o]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int g = 0; g < 2; ++g)
          so[col * OS + wm0 + i * 16 + er + 8 * g] = dequant(acc[i][j][2 * g + h], scale, bias, o);
    }
  __syncthreads();
  constexpr int V = 16 / sizeof(T), CPR = BM / V;   // elements a chunk, chunks a row
  const bool vec = P % V == 0;                      // no chunk crosses an image
#pragma unroll 1
  for (int idx = tid; idx < BN * CPR; idx += THREADS) {
    const int col = idx / CPR, m = m0 + (idx - col * CPR) * V, o = o0 + col;
    if (o >= O || m >= M) continue;
    const T* src = so + col * OS + (m - m0);
    if (vec) {
      const int n = m / P;
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(n) * O + o) * P + (m - n * P)) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < V && m + e < M; ++e) {
        const int n = (m + e) / P;
        out[(static_cast<size_t>(n) * O + o) * P + (m + e - n * P)] = src[e];
      }
    }
  }
}

// --- the depthwise entry: staged, coalesced, reused ---------------------------

constexpr int kSlab = 32;         // channels a block: one 32-byte run of a pixel
constexpr int kDwThreads = 256;   // a warp: 8 groups of 4 channels x 4 quads of 4 pixels

// Staged input columns of a band `cols` output pixels wide: its quads of 4
// output pixels with their halo, rounded up to whole groups of 4 slots.
__host__ __device__ constexpr int dw_in_cols(int cols, int stride) {
  return ((((cols + 3) / 4 * 4 - 1) * stride + 3) + 3) / 4 * 4;
}
__host__ __device__ constexpr int dw_smem_bytes(int rows, int cols, int stride) {
  return ((rows - 1) * stride + 3) * dw_in_cols(cols, stride) * kSlab;
}
// The slot of staged pixel p in its row: the 4 pixels of each group of 4
// are rotated by p / 4, so that the four lanes of a warp that read pixels 4
// apart (one each of four quads) hit four different 8-bank groups.
__device__ __forceinline__ int dw_slot(int p) { return (p & ~3) | ((p + (p >> 2)) & 3); }

// 4 values of T stored at once: 16 bytes of float32, 8 of bf16
template <typename T>
__device__ __forceinline__ void store4(T* dst, const T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  } else {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(v);
  }
}

// grid (ceil(OW / cols), ceil(OH / rows), N * Cp / 32): a block takes 32
// channels of `rows` x `cols` output pixels of one image. The input rows of
// the band (with their halo, 32 bytes a pixel) are staged once in shared
// memory; then each thread takes 4 channels of a quad of 4 output pixels
// (lane % 8: the channels, lane / 8: the quad), slides a window of input
// words along the quad for each of the 3 kernel rows, and stores each
// channel's 4 pixels at once: a warp's store is 8 channel rows x 64
// contiguous bytes (float32), whole sectors, with no staging of the output.
template <typename T, int S>
__global__ void __launch_bounds__(kDwThreads)
    depthwise_kernel(const signed char* __restrict__ xq, const signed char* __restrict__ wq,
                     const float* __restrict__ amax, const float* __restrict__ s_w,
                     const T* __restrict__ bias, T* __restrict__ out, int N, int H, int W, int C,
                     int Cp, int OH, int OW, int rows, int cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NW = 3 * S + 3;   // input words of a quad's window in one kernel row
  const int tid = threadIdx.x, slabs = Cp / kSlab;
  const int n = blockIdx.z / slabs, c0 = (blockIdx.z - n * slabs) * kSlab;
  const int oh0 = blockIdx.y * rows, ow0 = blockIdx.x * cols, quads = (cols + 3) / 4;
  const int in_rows = (rows - 1) * S + 3, in_cols = dw_in_cols(cols, S);
  const int ih0 = oh0 * S - 1, iw0 = ow0 * S - 1;

  for (int i = tid; i < in_rows * in_cols * 2; i += kDwThreads) {
    const int px = i >> 1, r = px / in_cols, p = px - r * in_cols;
    const int ih = ih0 + r, iw = iw0 + p;
    const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W;
    const signed char* src =
        ok ? xq + ((static_cast<size_t>(n) * H + ih) * W + iw) * Cp + c0 + 16 * (i & 1) : xq;
    cp_async16(smem + (r * in_cols + dw_slot(p)) * kSlab + 16 * (i & 1), src, ok);
  }
  cp_async_commit();

  // this thread's channels 4g .. 4g + 3 of the slab: their weights and scales
  const int g = tid & 7;
  int wv[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wv[t] = *reinterpret_cast<const int*>(wq + t * Cp + c0 + 4 * g);
  const float s = act_scale(amax);
  float scale[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int c = c0 + 4 * g + l;
    scale[l] = c < C ? __fmul_rn(s, s_w[c]) : 0.0f;
  }
  const bool vec = OW % 4 == 0 && cols % 4 == 0;   // a quad is 4 aligned pixels of a row
  cp_async_wait<0>();
  __syncthreads();

  for (int item = tid >> 3; item < rows * quads; item += kDwThreads / 8) {
    const int r = item / quads, q = item - r * quads, oh = oh0 + r, ow = ow0 + 4 * q;
    int acc[4][4] = {};   // [pixel][channel]
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const unsigned char* row = smem + (r * S + kh) * in_cols * kSlab + 4 * g;
      int xw[NW];
#pragma unroll
      for (int m = 0; m < NW; ++m)
        xw[m] = *reinterpret_cast<const int*>(row + dw_slot(4 * q * S + m) * kSlab);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int x = xw[j * S + kw], w = wv[kh * 3 + kw];
#pragma unroll
          for (int l = 0; l < 4; ++l)
            acc[j][l] += static_cast<int>(static_cast<signed char>(x >> (8 * l))) *
                         static_cast<int>(static_cast<signed char>(w >> (8 * l)));
        }
    }
    if (oh >= OH) continue;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int c = c0 + 4 * g + l;
      if (c >= C) continue;
      alignas(16) T v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = dequant(acc[j][l], scale[l], bias, c);
      T* dst = out + ((static_cast<size_t>(n) * C + c) * OH + oh) * OW + ow;
      if (vec && ow + 3 < OW) {
        store4(dst, v);
      } else {
        for (int j = 0; j < 4; ++j)
          if (4 * q + j < cols && ow + j < OW) dst[j] = v[j];
      }
    }
  }
}

// Shared memory above 48 KB, static and dynamic together, has to be allowed
// per kernel and per device; done at a kernel's first launch on a device
// (the wrapper makes the tensors' device current) and again only for a
// larger request, so a later launch (or a CUDA graph capture) calls no
// cudaFuncSetAttribute.
constexpr int kMaxDevices = 64;
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static int allowed[kMaxDevices] = {};   // 0: nothing above 48 KB allowed yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

template <typename T>
cudaError_t quantize(const void* x, const void* amax, void* out, int N, int C, int HW, int Cp,
                     void* stream) {
  if (N == 0 || HW == 0 || Cp == 0) return cudaSuccess;
  if (Cp % kChannelMultiple != 0 || C > Cp) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 8 != 0) return cudaErrorMisalignedAddress;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const bool vec = HW % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int chunks = (HW + kQuantizeTile - 1) / kQuantizeTile;
  const long long units = static_cast<long long>(N) * (Cp / kChannelMultiple) * chunks;
  constexpr int per_block = kQuantizeThreads / 32;
  quantize_kernel<T><<<static_cast<unsigned>((units + per_block - 1) / per_block),
                       kQuantizeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(amax), static_cast<signed char*>(out), N,
      C, HW, Cp, chunks, vec);
  return cudaGetLastError();
}

cudaError_t quantize_weight(const void* w, void* s_w, void* out, int O, int I, int K, int Cp,
                            int depthwise, void* stream) {
  if (O == 0) return cudaSuccess;
  if (Cp % kChannelMultiple != 0 || (K != 1 && K != 3)) return cudaErrorInvalidValue;
  if (depthwise ? (I != 1 || K != 3 || Cp < O || Cp - O >= kChannelMultiple)
                : (I < 1 || Cp < I || Cp - I >= kChannelMultiple))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 4 != 0) return cudaErrorMisalignedAddress;
  constexpr int warps = kWeightThreads / 32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (depthwise) {
    const int slabs = Cp / kChannelMultiple;
    quantize_weight_kernel<true><<<(slabs + warps - 1) / warps, kWeightThreads, 0, st>>>(
        static_cast<const float*>(w), static_cast<float*>(s_w), static_cast<signed char*>(out), O,
        I, K * K, Cp);
  } else {
    quantize_weight_kernel<false><<<O, kWeightThreads, 0, st>>>(
        static_cast<const float*>(w), static_cast<float*>(s_w), static_cast<signed char*>(out), O,
        I, K * K, Cp);
  }
  return cudaGetLastError();
}

template <typename T, typename Tile>
cudaError_t dense_launch(const void* xq, const void* wq, const void* amax, const void* s_w,
                         const void* bias, void* out, int N, int H, int W, int Cp, int O, int K,
                         int stride, int pad, int OH, int OW, void* stream) {
  const long long M = static_cast<long long>(N) * OH * OW;
  const dim3 grid(static_cast<unsigned>((M + Tile::BM - 1) / Tile::BM),
                  (O + Tile::BN - 1) / Tile::BN);
  constexpr int smem = Tile::template smem_bytes<T>();
  const cudaError_t err = allow_smem<dense_kernel<T, Tile>>(smem);
  if (err != cudaSuccess) return err;
  dense_kernel<T, Tile><<<grid, Tile::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(xq), static_cast<const signed char*>(wq),
      static_cast<const float*>(amax), static_cast<const float*>(s_w),
      static_cast<const T*>(bias), static_cast<T*>(out), N, H, W, Cp, O, K, stride, pad, OH, OW);
  return cudaGetLastError();
}

template <typename T>
int dense_smem(int tile) {
  switch (tile) {
    case 0: return Tile0::smem_bytes<T>();
    case 1: return Tile1::smem_bytes<T>();
    case 2: return Tile2::smem_bytes<T>();
    case 3: return Tile3::smem_bytes<T>();
    default: return -1;
  }
}

template <typename T>
cudaError_t dense(const void* xq, const void* wq, const void* amax, const void* s_w,
                  const void* bias, void* out, int N, int H, int W, int Cp, int O, int K,
                  int stride, int pad, int OH, int OW, int tile, void* stream) {
  if (static_cast<long long>(N) * OH * OW == 0 || O == 0) return cudaSuccess;
  if (Cp % kChannelMultiple != 0) return cudaErrorInvalidValue;
#define QCONV_DENSE(TILE)                                                                     \
  return dense_launch<T, TILE>(xq, wq, amax, s_w, bias, out, N, H, W, Cp, O, K, stride, pad, OH, \
                               OW, stream)
  switch (tile) {
    case 0: QCONV_DENSE(Tile0);
    case 1: QCONV_DENSE(Tile1);
    case 2: QCONV_DENSE(Tile2);
    case 3: QCONV_DENSE(Tile3);
    default: return cudaErrorInvalidValue;
  }
#undef QCONV_DENSE
}

template <typename T, int S>
cudaError_t depthwise_launch(const void* xq, const void* wq, const void* amax, const void* s_w,
                             const void* bias, void* out, int N, int H, int W, int C, int Cp,
                             int OH, int OW, int rows, int cols, void* stream) {
  const dim3 grid((OW + cols - 1) / cols, (OH + rows - 1) / rows, N * (Cp / kSlab));
  const int smem = dw_smem_bytes(rows, cols, S);
  const cudaError_t err = allow_smem<depthwise_kernel<T, S>>(smem);
  if (err != cudaSuccess) return err;
  depthwise_kernel<T, S><<<grid, kDwThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(xq), static_cast<const signed char*>(wq),
      static_cast<const float*>(amax), static_cast<const float*>(s_w),
      static_cast<const T*>(bias), static_cast<T*>(out), N, H, W, C, Cp, OH, OW, rows, cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t depthwise(const void* xq, const void* wq, const void* amax, const void* s_w,
                      const void* bias, void* out, int N, int H, int W, int C, int Cp, int stride,
                      int OH, int OW, int rows, int cols, void* stream) {
  if (static_cast<long long>(N) * OH * OW == 0 || C == 0) return cudaSuccess;
  if (Cp % kChannelMultiple != 0 || rows < 1 || cols < 1 || (stride != 1 && stride != 2))
    return cudaErrorInvalidValue;
  return stride == 1 ? depthwise_launch<T, 1>(xq, wq, amax, s_w, bias, out, N, H, W, C, Cp, OH,
                                              OW, rows, cols, stream)
                     : depthwise_launch<T, 2>(xq, wq, amax, s_w, bias, out, N, H, W, C, Cp, OH,
                                              OW, rows, cols, stream);
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

// w float32 [O, I, K, K] -> s_w float32 [O] and the layout: dense [O, K, K,
// Cp], Cp = I padded to 32; depthwise (I 1, K 3) [9, Cp], Cp = O padded.
int qconv_quantize_weight_f32(const void* w, void* s_w, void* out, int O, int I, int K, int Cp,
                              int depthwise, void* stream) {
  return quantize_weight(w, s_w, out, O, I, K, Cp, depthwise, stream);
}

int qconv_dense_f32(const void* xq, const void* wq, const void* amax, const void* s_w,
                    const void* bias, void* out, int N, int H, int W, int Cp, int O, int K,
                    int stride, int pad, int OH, int OW, int tile, void* stream) {
  return dense<float>(xq, wq, amax, s_w, bias, out, N, H, W, Cp, O, K, stride, pad, OH, OW, tile,
                      stream);
}

int qconv_dense_bf16(const void* xq, const void* wq, const void* amax, const void* s_w,
                     const void* bias, void* out, int N, int H, int W, int Cp, int O, int K,
                     int stride, int pad, int OH, int OW, int tile, void* stream) {
  return dense<__nv_bfloat16>(xq, wq, amax, s_w, bias, out, N, H, W, Cp, O, K, stride, pad, OH,
                              OW, tile, stream);
}

int qconv_depthwise_f32(const void* xq, const void* wq, const void* amax, const void* s_w,
                        const void* bias, void* out, int N, int H, int W, int C, int Cp,
                        int stride, int OH, int OW, int rows, int cols, void* stream) {
  return depthwise<float>(xq, wq, amax, s_w, bias, out, N, H, W, C, Cp, stride, OH, OW, rows,
                          cols, stream);
}

int qconv_depthwise_bf16(const void* xq, const void* wq, const void* amax, const void* s_w,
                         const void* bias, void* out, int N, int H, int W, int C, int Cp,
                         int stride, int OH, int OW, int rows, int cols, void* stream) {
  return depthwise<__nv_bfloat16>(xq, wq, amax, s_w, bias, out, N, H, W, C, Cp, stride, OH, OW,
                                  rows, cols, stream);
}

// The dynamic shared memory a launch takes, for the wrapper's plan to be
// held against: the dense entry by tile, the depthwise entry by band.
int qconv_dense_smem_bytes(int tile, int bf16) {
  return bf16 ? dense_smem<__nv_bfloat16>(tile) : dense_smem<float>(tile);
}

int qconv_depthwise_smem_bytes(int rows, int cols, int stride) {
  return dw_smem_bytes(rows, cols, stride);
}

const char* qconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
