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
// What bounds them on an H100. At mid_attn's shape [B, 1024, 4, 32] the
// forward's two products are 4 * B * H * N^2 * D = 0.537 GFLOP an image
// against 2.1 MB of q, k, v and out in f32 (half that in bf16): bound by
// operations in both dtypes, as attention is at any N above ~100 at D = 32:
// 0.54 us in bf16 on the tensor cores (989 TFLOP/s), 3.3 us in f32 as
// 3xTF32 (three TF32 products at 495 TFLOP/s each). The backward does seven
// such products in its two kernels (dK/dV: k q^T, v dO^T, P^T dO, dS^T q;
// dQ: q k^T, dO v^T, dS k; the dQ kernel recomputes the first two rather
// than write [N, N] scores): 1.88 GFLOP an image, 1.9 us in bf16 and 11.4 us
// in f32 as 3xTF32. What holds them above that is latency and issue: a
// warp's chain of mma.sync, exp2f (the SFU) and repacking per chunk, with
// few warps an SM at batch 1.
//
// All three kernels run on the tensor cores. Each warp owns 16 rows of S, the
// M of a warp-level mma.sync: queries in the forward (S = q k^T) and in dQ
// (S = q k^T, dP = dO v^T), keys in dK/dV, which computes S^T = k q^T and
// dP^T = v dO^T with the keys as rows. It walks the other side 16 columns
// (a chunk) at a time. A chunk's products leave S (and dP) in accumulator
// fragments; P (and dS) are formed in those registers and packed straight
// into the A fragments of the next products (out += P v; dV += P^T dO and
// dK += dS^T q; dQ += dS k): no P or dS tile in shared memory and no barrier
// between a chunk's halves.
//   bf16: mma.sync m16n8k16, bf16 in, f32 accumulate, B fragments by ldmatrix
//     (.trans where the product runs along the staged rows); P and dS are
//     rounded to bf16 (cvt.rn, to nearest even) as they are packed, as the
//     stock kernels cast them before their dots (p.astype(v.dtype)).
//   f32: mma.sync m16n8k8 in TF32, as 3xTF32: every operand, P and dS too,
//     is split into big = tf32(x) and small = x - big cut to TF32, and
//     small.big + big.small + big.big accumulate in f32, within a small
//     factor of an f32 product (a single TF32 pass is not float32). A chunk's
//     products into a long-running accumulator are summed apart, from zero,
//     then added in f32. A lane's accumulator columns (2t, 2t + 1) are not a
//     TF32 A fragment's (t, t + 4), but the order of k within a product is
//     free: a lane's P and dS go in as they lie, and its B fragment reads the
//     matching rows 2t and 2t + 1 of v, dO or q, so no shuffle is needed.
//
// The forward (the stock `_flash_attention_kernel_single_batch`, :342-481).
// Its first design ran both products on the CUDA cores (a thread's 4 x 4
// micro tile of FMAs), staged bf16 widened to f32, passed P through shared
// memory with three barriers a tile and ran one 64-row block a query tile
// (64 blocks on 132 SMs at mid_attn, batch 1): bound by issue, not by the
// card. Here a warp holds its 16 query rows' A fragments and, per chunk of
// 16 keys: S = q k^T (keys past N -inf, masked in the last chunk only); the
// chunk's max of the raw scores (a row's max over its quad by two shuffles),
// scaled once into the running m2 = max * scale * log2(e), so that P =
// exp2(fma(S, scale * log2(e), -m2)) takes one fused multiply-add and m2 is
// the scaled scores' max (scale > 0, checked at launch); where a row's m2
// moved, alpha = exp2(m2_old - m2_new) rescales l and the row's accumulator
// (a warp vote skips the rescale where no row's max moved: every alpha
// would be 1); each lane sums its own columns of the unrounded f32 P into
// its share of the row sum l (the quad's four shares are added once, at the
// end); acc += P v, P rounded to bf16 on its way in, in the bf16 entry. A
// max a chunk beat a max over a warp's chunks of a staged tile (S of the
// whole tile in registers) in five of six timed cases, by up to 17 % (4 %
// slower in bf16 at mid_attn, batch 8).
// At the end out = acc / l and, when asked, the f32 log-sum-exp [B, H, N]
// in natural-log units, lse = m2 * ln(2) + log(l) (m2 converted once),
// which the backward reads and multiplies by log2(e). exp2f, not __expf:
// its denormal-safe form (a compare and two predicated multiplies around
// each MUFU.EX2) is a quarter of the chunk's instructions, and with the
// rows' max, shuffles and sums it, not the tensor cores, bounds the forward
// at D = 32.
//
// The backward. The dQ kernel runs first: it owns the query rows, so it
// also forms each row's di = sum(o * dO) (the stock VJP's one row
// reduction, which it computes in XLA between its kernels) and writes it
// [B, H, N] for dK/dV. Each forms P = exp2(S * scale * log2(e) -
// lse * log2(e)) and dS = (dP - di) * P * scale.
//
// Staging: the block's own rows (q in the forward; k, v in dK/dV; q, dO in
// dQ) once, then the other side's tiles through a ring of two stages of
// 16-byte cp.async in the type they arrive in, so that the next tile loads
// while this one is used; rows past N are zero-filled, and dK/dV stages each
// query tile's lse and di beside it (+inf and 0 past N, so such a query's P
// is 0). The forward stages 128 keys a tile (64 in f32 at D = 128), waits
// for a tile and then issues the next one's copies after its one barrier a
// tile (every warp is past the tile before it); the backward stages 64 rows
// (32 in f32 at D = 128), issues first and takes a second barrier at the
// tile's end. Staged rows are padded by 16 bytes, so the 8 rows an ldmatrix
// reads (bf16) and a quad's scalar loads (f32) fall in distinct banks. A
// warp keeps its own rows' A fragments in registers where they fit (bf16 at
// D <= 64, f32 at D = 32), else reads them a step at a time.
// The plan (flash_attention_plan), one rule for all three kernels: rows a
// block (16 to 128, a warp each 16 rows) and split (1, 2 or 4 warps on the
// same 16 rows, each taking every split-th chunk of a tile), chosen to fill
// an H100's 132 SMs: the most rows that still give 128 blocks (fewer, larger
// blocks read the other side from L2 fewer times), then the least split
// that gives eight warps an SM. A split block sums its warps' partial dK, dV
// or dQ through shared memory in warp order; in the forward each part keeps
// its own (m2, l, acc) and part 0 merges them in warp order: m2 = max m2_p,
// l = sum l_p 2^(m2_p - m2), acc = sum acc_p 2^(m2_p - m2). A part that saw
// no key (N below split x 16 columns of a tile) has m2_p = -inf, l_p = 0
// and acc_p = 0 and adds exactly 0: part 0 always sees key 0, so m2 is
// finite and no -inf - -inf arises. (scripts/torch_port_flash_ab.py --sweep
// times every plan.)
//
// No atomics and a fixed order of every sum (each mma's, each chunk's, each
// split's), so reruns are bit-identical; no scratch in device memory: a
// launch writes only its outputs, so every kernel captures into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ long long offset(int b, int n, int h, int N, int H, int D) {
  return ((static_cast<long long>(b) * N + n) * H + h) * D;
}

constexpr int kWarpRows = 16;    // rows of S a warp owns: mma's M
constexpr int kChunk = 16;       // columns of S a warp forms at a time
constexpr int kMaxWarps = 8;
constexpr int kThreads = 32 * kMaxWarps;  // with one block an SM: up to 255 registers
constexpr int kSMs = 132;        // an H100 SXM's
constexpr int kMinBlocks = 128;  // the plan's least grid, where N allows
constexpr int kSmemMax = 232448;  // shared memory a block may use on sm_90
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Elements of a staged row: D and 16 bytes of pad.
template <typename T, int D>
__host__ __device__ constexpr int bpitch() { return D + 16 / static_cast<int>(sizeof(T)); }

// Rows of a staged tile of the other side (queries in dK/dV, keys in dQ).
template <typename T, int D>
__host__ __device__ constexpr int bcols() { return sizeof(T) == 4 && D == 128 ? 32 : 64; }

// Rows of a staged key tile of the forward.
template <typename T, int D>
__host__ __device__ constexpr int fcols() { return sizeof(T) == 4 && D == 128 ? 64 : 128; }

// Whether a warp keeps the A fragments of its own rows in registers.
template <typename T, int D>
__host__ __device__ constexpr bool held() { return sizeof(T) * D <= 128; }

// One mma step: its depth K, the registers of a lane's A fragment (f32: big
// then small) and of its B fragment of one 8-column block.
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> { static constexpr int K = 16, A = 4, B = 2; };
template <> struct Mma<float> { static constexpr int K = 8, A = 8, B = 4; };

// Inline PTX: every instruction the kernels use beyond plain C++.

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

// Four 8 x 16-byte matrices from shared memory: lanes 8q .. 8q + 7 give the
// rows of matrix q, and each lane receives, of matrix q, the 4 bytes
// 4 * (lane % 4) .. + 3 of its row lane / 4 in r[q]; with .trans, the 2-byte
// elements (2 (lane % 4), lane / 4) and (2 (lane % 4) + 1, lane / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Asynchronous copies from device to shared memory (cp.async); with valid
// false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// End of inline PTX.

// big = tf32(v), to nearest with ties away from zero (what cvt.rna.tf32.f32
// computes for finite v), small = v - big (exact in f32) cut to TF32 toward
// zero; big + small is within 2^-21 of v, relatively.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

// d += a . b: one bf16 product, or 3xTF32's three (a and b hold big, then
// small).
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t* a, const uint32_t* b) {
  if constexpr (sizeof(T) == 2) {
    mma_bf16(d, a, b);
  } else {
    mma_tf32(d, a + 4, b);
    mma_tf32(d, a, b + 2);
    mma_tf32(d, a, b);
  }
}

// Rows [row0, row0 + rows) of head h of batch element b of x [B, N, H, D]
// into dst (pitch bpitch) by 16-byte cp.async, in x's own type; rows past N
// are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage_async(T* dst, const T* __restrict__ x, int b, int h,
                                            int row0, int rows, int N, int H) {
  constexpr int E = 16 / static_cast<int>(sizeof(T)), V = D / E;
  for (int i = threadIdx.x; i < rows * V; i += blockDim.x) {
    const int r = i / V, c = (i % V) * E, n = row0 + r;
    cp_async16(dst + r * bpitch<T, D>() + c, x + offset(b, n < N ? n : 0, h, N, H, D) + c, n < N);
  }
}

// lse and di of rows [row0, row0 + rows) from [B, H, N] f32; past N +inf
// (so that P = exp2(S - lse) is 0 there) and 0, stored directly.
__device__ __forceinline__ void stage_rows_async(float* slse, float* sdi,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ di, int b, int h,
                                                 int row0, int rows, int N, int H) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int n = row0 + i;
    const long long at = (static_cast<long long>(b) * H + h) * N + n;
    if (n < N) {
      cp_async4(slse + i, lse + at);
      cp_async4(sdi + i, di + at);
    } else {
      slse[i] = INFINITY;
      sdi[i] = 0.0f;
    }
  }
}

// big and small of four values into a TF32 A fragment f[0..3], f[4..7].
__device__ __forceinline__ void split4(uint32_t* f, float v0, float v1, float v2, float v3) {
  split_tf32(v0, f[0], f[4]);
  split_tf32(v1, f[1], f[5]);
  split_tf32(v2, f[2], f[6]);
  split_tf32(v3, f[3], f[7]);
}

// This lane's A fragment of step ks of the 16 staged rows r0 .. r0 + 15 of
// tile (the rows of the product, the staged columns its depth).
template <typename T, int D>
__device__ __forceinline__ void load_a(uint32_t* f, const T* tile, int r0, int ks, int lane) {
  constexpr int P = bpitch<T, D>();
  if constexpr (sizeof(T) == 2) {
    ldmatrix_x4(f, tile + (r0 + (lane & 15)) * P + ks * 16 + (lane >> 4) * 8);
  } else {
    const float* x = tile + (r0 + (lane >> 2)) * P + ks * 8 + (lane & 3);
    split4(f, x[0], x[8 * P], x[4], x[8 * P + 4]);
  }
}

// This lane's B fragments of step ks for the 8-column blocks j and j + 8 of
// a product whose columns are the staged rows j .. j + 15 (f[0 .. B) and
// f[B .. 2B)).
template <typename T, int D>
__device__ __forceinline__ void load_b(uint32_t* f, const T* tile, int j, int ks, int lane) {
  constexpr int P = bpitch<T, D>();
  if constexpr (sizeof(T) == 2) {
    ldmatrix_x4(f, tile + (j + (lane & 7) + ((lane >> 4) << 3)) * P + ks * 16 +
                       ((lane >> 3) & 1) * 8);
  } else {
    const float* x = tile + (j + (lane >> 2)) * P + ks * 8 + (lane & 3);
    split_tf32(x[0], f[0], f[2]);
    split_tf32(x[4], f[1], f[3]);
    split_tf32(x[8 * P], f[4], f[6]);
    split_tf32(x[8 * P + 4], f[5], f[7]);
  }
}

// This lane's B fragments for the output columns n0 .. n0 + 7 and
// n0 + 8 .. n0 + 15 of a product whose depth runs along the staged rows
// j .. j + 15: bf16 one k16 step (ldmatrix .trans); f32 the k8 step kk over
// rows j + 8 kk .., its k = t and t + 4 being rows 2t and 2t + 1 (the order
// in which an accumulator fragment holds its columns).
template <typename T, int D>
__device__ __forceinline__ void load_bt(uint32_t* f, const T* tile, int j, int kk, int n0,
                                        int lane) {
  constexpr int P = bpitch<T, D>();
  if constexpr (sizeof(T) == 2) {
    ldmatrix_x4_trans(f, tile + (j + (lane & 7) + (((lane >> 3) & 1) << 3)) * P + n0 +
                             (lane >> 4) * 8);
  } else {
    const float* x = tile + (j + 8 * kk + 2 * (lane & 3)) * P + n0 + (lane >> 2);
    split_tf32(x[0], f[0], f[2]);
    split_tf32(x[P], f[1], f[3]);
    split_tf32(x[8], f[4], f[6]);
    split_tf32(x[P + 8], f[5], f[7]);
  }
}

// A warp's A fragments of its own 16 staged rows: kept in registers where
// held<T, D>(), else read from the tile a step at a time.
template <typename T, int D>
struct RowFrags {
  static constexpr int K = Mma<T>::K, A = Mma<T>::A;
  uint32_t f[held<T, D>() ? D / K : 1][A];
  const T* tile;
  int r0;

  __device__ __forceinline__ void load(const T* t, int r, int lane) {
    tile = t;
    r0 = r;
    if constexpr (held<T, D>()) {
#pragma unroll
      for (int ks = 0; ks < D / K; ++ks) load_a<T, D>(f[ks], t, r, ks, lane);
    }
  }
  __device__ __forceinline__ const uint32_t* step(int ks, uint32_t* buf, int lane) const {
    if constexpr (held<T, D>()) return f[ks];
    load_a<T, D>(buf, tile, r0, ks, lane);
    return buf;
  }
};

// s = (own rows) . (staged rows j .. j + 15)^T over D: a 16 x 16 chunk of S
// (or dP) as two accumulator fragments, s[nb][i] at row g + 8 (i / 2), column
// j + 8 nb + 2t + i % 2 for lane 4g + t.
template <typename T, int D>
__device__ __forceinline__ void scores(float (&s)[2][4], const RowFrags<T, D>& a, const T* tile,
                                       int j, int lane) {
  constexpr int K = Mma<T>::K, B = Mma<T>::B;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nb][i] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < D / K; ++ks) {
    uint32_t buf[Mma<T>::A], b[2 * B];
    const uint32_t* af = a.step(ks, buf, lane);
    load_b<T, D>(b, tile, j, ks, lane);
    mma<T>(s[0], af, b);
    mma<T>(s[1], af, b + B);
  }
}

// acc += w . x[j .. j + 15]: w the 16 x 16 chunk of P or dS a lane holds as
// scores() leaves it, rounded to bf16 (bf16 entry) or split (f32) on the way
// into the A fragment; x the staged rows j .. j + 15, all D columns. bf16
// accumulates in acc; f32 sums the chunk apart and adds it to acc.
template <typename T, int D>
__device__ __forceinline__ void accumulate_chunk(float (&acc)[D / 8][4], const float (&w)[2][4],
                                                 const T* tile, int j, int lane) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t a[4] = {bf16x2_rn(w[0][0], w[0][1]), bf16x2_rn(w[0][2], w[0][3]),
                           bf16x2_rn(w[1][0], w[1][1]), bf16x2_rn(w[1][2], w[1][3])};
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t b[4];
      load_bt<T, D>(b, tile, j, 0, 16 * n, lane);
      mma_bf16(acc[2 * n], a, b);
      mma_bf16(acc[2 * n + 1], a, b + 2);
    }
  } else {
    // the chunk's six TF32 products from zero, then one f32 add: the tensor
    // cores' own additions into a long-running accumulator lose more
    uint32_t a[2][8];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) split4(a[kk], w[kk][0], w[kk][2], w[kk][1], w[kk][3]);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      float part[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t b[8];
        load_bt<T, D>(b, tile, j, kk, 16 * n, lane);
        mma<T>(part[0], a[kk], b);
        mma<T>(part[1], a[kk], b + 4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[2 * n][i] += part[0][i];
        acc[2 * n + 1][i] += part[1][i];
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void zero_frags(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int a = 0; a < D / 8; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[a][i] = 0.0f;
}

// A split block's partial sums: parts 1 .. split - 1 of each row group put
// theirs in shared memory (one slot a warp, a lane's values 32 floats apart),
// part 0 adds them in part order.
template <int D>
__device__ __forceinline__ void put_frags(float* slot, const float (&acc)[D / 8][4], int lane) {
#pragma unroll
  for (int a = 0; a < D / 8; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) slot[(4 * a + i) * 32 + lane] = acc[a][i];
}
template <int D>
__device__ __forceinline__ void add_frags(float (&acc)[D / 8][4], const float* slot, int lane) {
#pragma unroll
  for (int a = 0; a < D / 8; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[a][i] += slot[(4 * a + i) * 32 + lane];
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Rows row0 .. row0 + 15 of y (those below N) from a warp's fragments.
template <typename T, int D>
__device__ __forceinline__ void store_frags(T* __restrict__ y, const float (&acc)[D / 8][4],
                                            int b, int h, int row0, int N, int H, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = row0 + (lane >> 2) + 8 * half;
    if (n >= N) continue;
    T* row = y + offset(b, n, h, N, H, D) + 2 * (lane & 3);
#pragma unroll
    for (int a = 0; a < D / 8; ++a) store2(row + 8 * a, acc[a][2 * half], acc[a][2 * half + 1]);
  }
}

// Floats of a warp's slot for the split sum, for `accs` accumulators.
template <int D>
__host__ __device__ constexpr int slot_floats(int accs) { return accs * 16 * D; }

// Floats of a forward part's slot for the split merge: its accumulator, then
// its lanes' m2 and l of rows g and g + 8.
template <int D>
__host__ __device__ constexpr int fwd_slot_floats() { return slot_floats<D>(1) + 4 * 32; }

// The forward: one block per `rows` queries (blockDim.x / 32 / split row
// groups of 16), the keys in tiles of fcols. Lane 4g + t of a warp keeps,
// for its rows g and g + 8, m2 = (the running max of the raw scores) *
// scale * log2(e) (scale > 0) and its share of l.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse, int N, int H, float scale,
                     int split) {
  constexpr int P = bpitch<T, D>(), BC = fcols<T, D>();
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = blockDim.x / 32 / split, rows = kWarpRows * groups;
  const int rg = warp / split, part = warp % split;
  const int q0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + rows * P;  // [stage][k, v][BC rows]

  const int tiles = (N + BC - 1) / BC;
  stage_async<T, D>(sq, q, b, h, q0, rows, N, H);
  stage_async<T, D>(sk, k, b, h, 0, BC, N, H);
  stage_async<T, D>(sk + BC * P, v, b, h, 0, BC, N, H);
  cp_async_commit();

  RowFrags<T, D> fq;
  float acc[D / 8][4];
  zero_frags<D>(acc);
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float c = scale * kLog2e;
  const int t4 = lane & 3;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BC, cur = t & 1;
    cp_async_wait<0>();
    __syncthreads();  // this tile is in, and every warp is done with the other stage
    if (t == 0) fq.load(sq, kWarpRows * rg, lane);
    if (t + 1 < tiles) {
      T* nk = sk + 2 * BC * P * (cur ^ 1);
      stage_async<T, D>(nk, k, b, h, k0 + BC, BC, N, H);
      stage_async<T, D>(nk + BC * P, v, b, h, k0 + BC, BC, N, H);
      cp_async_commit();
    }
    const T* tk = sk + 2 * BC * P * cur;
    const T* tv = tk + BC * P;
    for (int j = kChunk * part; j < BC && k0 + j < N; j += kChunk * split) {
      // rows: this warp's queries; columns: keys j .. j + 15 of the tile
      float s[2][4];
      scores<T, D>(s, fq, tk, j, lane);
      if (k0 + j + kChunk > N) {  // the last chunk: its keys past N are -inf
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + j + 8 * nb + 2 * t4 + (i & 1) >= N) s[nb][i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[nb][i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // finite: the chunk has a key
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m2[r], mx[r] * c);  // the new m2
      }
      // alpha = 2^(m2_old - m2_new) rescales l and acc (0 on the first chunk);
      // where no row of the warp has a new max every alpha is 1: skipped
      if (__any_sync(0xffffffffu, mx[0] != m2[0] || mx[1] != m2[1])) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float alpha = exp2f(m2[r] - mx[r]);
          l[r] *= alpha;
#pragma unroll
          for (int a = 0; a < D / 8; ++a) {
            acc[a][2 * r] *= alpha;
            acc[a][2 * r + 1] *= alpha;
          }
          m2[r] = mx[r];
        }
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[nb][i] = exp2f(fmaf(s[nb][i], c, -m2[i >> 1]));
          l[i >> 1] += s[nb][i];
        }
      accumulate_chunk<T, D>(acc, s, tv, j, lane);  // out += P v
    }
  }
  if (split > 1) {
    __syncthreads();  // everything staged has been used
    if (part > 0) {
      float* slot = smem + ((part - 1) * groups + rg) * fwd_slot_floats<D>();
      put_frags<D>(slot, acc, lane);
      float* ml = slot + slot_floats<D>(1);
      ml[lane] = m2[0];
      ml[32 + lane] = m2[1];
      ml[64 + lane] = l[0];
      ml[96 + lane] = l[1];
    }
    __syncthreads();
    if (part == 0) {  // m2 = max m2_p; l, acc = sum over p of l_p, acc_p * 2^(m2_p - m2)
      float mt[2] = {m2[0], m2[1]};
      for (int p = 1; p < split; ++p) {
        const float* ml = smem + ((p - 1) * groups + rg) * fwd_slot_floats<D>() + slot_floats<D>(1);
        mt[0] = fmaxf(mt[0], ml[lane]);
        mt[1] = fmaxf(mt[1], ml[32 + lane]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float f = exp2f(m2[r] - mt[r]);
        l[r] *= f;
#pragma unroll
        for (int a = 0; a < D / 8; ++a) {
          acc[a][2 * r] *= f;
          acc[a][2 * r + 1] *= f;
        }
        m2[r] = mt[r];
      }
      // a part that saw no key kept m2 = -inf (its max never moved), l = 0 and
      // acc = 0: its factor 2^-inf = 0 adds exactly 0 (part 0 saw key 0, so
      // the max is finite and no -inf - -inf arises)
      for (int p = 1; p < split; ++p) {
        const float* from = smem + ((p - 1) * groups + rg) * fwd_slot_floats<D>();
        const float* ml = from + slot_floats<D>(1);
        const float f[2] = {exp2f(ml[lane] - m2[0]), exp2f(ml[32 + lane] - m2[1])};
        l[0] = fmaf(ml[64 + lane], f[0], l[0]);
        l[1] = fmaf(ml[96 + lane], f[1], l[1]);
#pragma unroll
        for (int a = 0; a < D / 8; ++a)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[a][i] = fmaf(from[(4 * a + i) * 32 + lane], f[i >> 1], acc[a][i]);
      }
    }
  }
  if (part == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the quad's four shares of l
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int a = 0; a < D / 8; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[a][i] /= l[i >> 1];
    store_frags<T, D>(out, acc, b, h, q0 + kWarpRows * rg, N, H, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = q0 + kWarpRows * rg + (lane >> 2) + 8 * r;
      if (lse != nullptr && t4 == 0 && n < N)
        lse[(static_cast<long long>(b) * H + h) * N + n] = m2[r] * kLn2 + logf(l[r]);
    }
  }
}

// dK/dV: one block per `rows` keys (blockDim.x / 32 / split row groups of
// 16), the queries in tiles of bcols.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         T* __restrict__ dk, T* __restrict__ dv, int N, int H, float scale,
                         int split) {
  constexpr int P = bpitch<T, D>(), BC = bcols<T, D>();
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = blockDim.x / 32 / split, rows = kWarpRows * groups;
  const int rg = warp / split, part = warp % split;
  const int k0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + rows * P;
  T* sq = sv + rows * P;  // [stage][q, dO][BC rows]
  float* srow = reinterpret_cast<float*>(sq + 4 * BC * P);  // [stage][lse, di][BC]

  const int tiles = (N + BC - 1) / BC;
  stage_async<T, D>(sk, k, b, h, k0, rows, N, H);
  stage_async<T, D>(sv, v, b, h, k0, rows, N, H);
  stage_async<T, D>(sq, q, b, h, 0, BC, N, H);
  stage_async<T, D>(sq + BC * P, dout, b, h, 0, BC, N, H);
  stage_rows_async(srow, srow + BC, lse, di, b, h, 0, BC, N, H);
  cp_async_commit();

  RowFrags<T, D> fk, fv;
  float adk[D / 8][4], adv[D / 8][4];
  zero_frags<D>(adk);
  zero_frags<D>(adv);
  const float c = scale * kLog2e;
  const int t4 = lane & 3;
  for (int t = 0; t < tiles; ++t) {
    const int q0 = t * BC, cur = t & 1;
    if (t + 1 < tiles) {
      T* nq = sq + 2 * BC * P * (cur ^ 1);
      float* nrow = srow + 2 * BC * (cur ^ 1);
      stage_async<T, D>(nq, q, b, h, q0 + BC, BC, N, H);
      stage_async<T, D>(nq + BC * P, dout, b, h, q0 + BC, BC, N, H);
      stage_rows_async(nrow, nrow + BC, lse, di, b, h, q0 + BC, BC, N, H);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile (and, first, the block's k and v) is in
    if (t == 0) {
      fk.load(sk, kWarpRows * rg, lane);
      fv.load(sv, kWarpRows * rg, lane);
    }
    const T* tq = sq + 2 * BC * P * cur;
    const T* tdo = tq + BC * P;
    const float* tl = srow + 2 * BC * cur;
    const float* tdi = tl + BC;
    for (int j = kChunk * part; j < BC && q0 + j < N; j += kChunk * split) {
      // rows: this warp's keys; columns: queries j .. j + 15 of the tile
      float s[2][4], dp[2][4];
      scores<T, D>(s, fk, tq, j, lane);
      scores<T, D>(dp, fv, tdo, j, lane);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = j + 8 * nb + 2 * t4 + (i & 1);
          const float p = exp2f(fmaf(s[nb][i], c, -tl[col] * kLog2e));
          dp[nb][i] = (dp[nb][i] - tdi[col]) * p * scale;
          s[nb][i] = p;
        }
      accumulate_chunk<T, D>(adv, s, tdo, j, lane);   // dV[key] += sum_q P[q][key] dO[q]
      accumulate_chunk<T, D>(adk, dp, tq, j, lane);   // dK[key] += sum_q dS[q][key] q[q]
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  if (split > 1) {    // everything staged has been used
    if (part > 0) {
      float* slot = smem + ((part - 1) * groups + rg) * slot_floats<D>(2);
      put_frags<D>(slot, adk, lane);
      put_frags<D>(slot + slot_floats<D>(1), adv, lane);
    }
    __syncthreads();
    for (int p = 1; part == 0 && p < split; ++p) {
      const float* from = smem + ((p - 1) * groups + rg) * slot_floats<D>(2);
      add_frags<D>(adk, from, lane);
      add_frags<D>(adv, from + slot_floats<D>(1), lane);
    }
  }
  if (part == 0) {
    store_frags<T, D>(dk, adk, b, h, k0 + kWarpRows * rg, N, H, lane);
    store_frags<T, D>(dv, adv, b, h, k0 + kWarpRows * rg, N, H, lane);
  }
}

// di = sum_d o[n][d] dO[n][d] of row n (0 past N) in f32: each lane of a
// quad sums a quarter of the row in order (16-byte loads), then two
// butterfly shuffles; the quad's four lanes end with the same value.
template <typename T, int D>
__device__ __forceinline__ float out_dot(const T* __restrict__ o, const T* __restrict__ dout,
                                         int b, int n, int h, int N, int H, int lane) {
  constexpr int E = 16 / static_cast<int>(sizeof(T)), Q = D / 4;
  float acc = 0.0f;
  if (n < N) {
    const long long at = offset(b, n, h, N, H, D) + (lane & 3) * Q;
#pragma unroll 1
    for (int c = 0; c < Q; c += E) {  // one vector pair at a time: few registers
      const uint4 ov = *reinterpret_cast<const uint4*>(o + at + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + at + c);
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int e = 0; e < E; ++e) acc = fmaf(to_float(oe[e]), to_float(de[e]), acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  return acc + __shfl_xor_sync(0xffffffffu, acc, 2);
}

// dQ: one block per `rows` queries, the keys in tiles of bcols; it also
// forms di of its rows from o and dO and writes it for dK/dV.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const T* __restrict__ o, const float* __restrict__ lse,
                        float* __restrict__ di, T* __restrict__ dq, int N, int H, float scale,
                        int split) {
  constexpr int P = bpitch<T, D>(), BC = bcols<T, D>();
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = blockDim.x / 32 / split, rows = kWarpRows * groups;
  const int rg = warp / split, part = warp % split;
  const int q0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + rows * P;
  T* sk = sdo + rows * P;  // [stage][k, v][BC rows]

  const int tiles = (N + BC - 1) / BC;
  stage_async<T, D>(sq, q, b, h, q0, rows, N, H);
  stage_async<T, D>(sdo, dout, b, h, q0, rows, N, H);
  stage_async<T, D>(sk, k, b, h, 0, BC, N, H);
  stage_async<T, D>(sk + BC * P, v, b, h, 0, BC, N, H);
  cp_async_commit();

  // the lane's rows g and g + 8: lse * log2(e) once a row (+inf past N) and di
  float lrow[2], drow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = q0 + kWarpRows * rg + (lane >> 2) + 8 * half;
    const long long at = (static_cast<long long>(b) * H + h) * N + n;
    lrow[half] = n < N ? lse[at] * kLog2e : INFINITY;
    drow[half] = out_dot<T, D>(o, dout, b, n, h, N, H, lane);
    if (part == 0 && (lane & 3) == 0 && n < N) di[at] = drow[half];
  }

  RowFrags<T, D> fq, fdo;
  float adq[D / 8][4];
  zero_frags<D>(adq);
  const float c = scale * kLog2e;
  const int t4 = lane & 3;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BC, cur = t & 1;
    if (t + 1 < tiles) {
      T* nk = sk + 2 * BC * P * (cur ^ 1);
      stage_async<T, D>(nk, k, b, h, k0 + BC, BC, N, H);
      stage_async<T, D>(nk + BC * P, v, b, h, k0 + BC, BC, N, H);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile (and, first, the block's q and dO) is in
    if (t == 0) {
      fq.load(sq, kWarpRows * rg, lane);
      fdo.load(sdo, kWarpRows * rg, lane);
    }
    const T* tk = sk + 2 * BC * P * cur;
    const T* tv = tk + BC * P;
    for (int j = kChunk * part; j < BC && k0 + j < N; j += kChunk * split) {
      // rows: this warp's queries; columns: keys j .. j + 15 of the tile
      float s[2][4], dp[2][4];
      scores<T, D>(s, fq, tk, j, lane);
      scores<T, D>(dp, fdo, tv, j, lane);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool key = k0 + j + 8 * nb + 2 * t4 + (i & 1) < N;
          const float p = key ? exp2f(fmaf(s[nb][i], c, -lrow[i >> 1])) : 0.0f;
          dp[nb][i] = (dp[nb][i] - drow[i >> 1]) * p * scale;
        }
      accumulate_chunk<T, D>(adq, dp, tk, j, lane);   // dQ[q] += sum_key dS[q][key] k[key]
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  if (split > 1) {
    if (part > 0) put_frags<D>(smem + ((part - 1) * groups + rg) * slot_floats<D>(1), adq, lane);
    __syncthreads();
    for (int p = 1; part == 0 && p < split; ++p)
      add_frags<D>(adq, smem + ((p - 1) * groups + rg) * slot_floats<D>(1), lane);
  }
  if (part == 0) store_frags<T, D>(dq, adq, b, h, q0 + kWarpRows * rg, N, H, lane);
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

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// A launch: rows of the block's own side, warps on each 16 of them (split),
// rows of a staged tile of the other side (cols), warps, grid, dynamic
// shared memory in bytes.
struct Plan {
  int rows, split, cols, warps, smem;
  dim3 grid;
};

enum Kernel { kForward = 0, kDkv = 1, kDq = 2 };

template <typename T, int D>
int plan_smem(int kernel, int rows, int split) {
  constexpr int P = bpitch<T, D>();
  const bool fwd = kernel == kForward;
  const int BC = fwd ? fcols<T, D>() : bcols<T, D>();
  const int staged = ((fwd ? 1 : 2) * rows + 4 * BC) * P * static_cast<int>(sizeof(T)) +
                     (kernel == kDkv ? 4 * BC * 4 : 0);
  const int slot = fwd ? fwd_slot_floats<D>() : slot_floats<D>(kernel == kDkv ? 2 : 1);
  const int reduced = (split - 1) * (rows / kWarpRows) * slot * 4;
  return staged > reduced ? staged : reduced;
}

// The plan of one call; rows = split = 0 asks for the default. False for a
// plan the kernel does not take (rows not 16, 32, 64 or 128; split not 1,
// 2 or 4, or above a staged tile's chunks; more than 8 warps; more shared
// memory than a block has).
template <typename T, int D>
bool plan_d(int kernel, int B, int N, int H, int rows, int split, Plan* p) {
  const auto blocks = [&](int r) { return static_cast<long long>((N + r - 1) / r) * H * B; };
  if (rows == 0) {  // the most rows that still give a block to nearly every SM
    rows = kWarpRows;
    for (int r = 128; r > kWarpRows; r /= 2) {
      if (blocks(r) >= kMinBlocks) {
        rows = r;
        break;
      }
    }
  }
  const int cols = kernel == kForward ? fcols<T, D>() : bcols<T, D>();
  const int groups = rows / kWarpRows, chunks = cols / kChunk;
  if (split == 0) {  // then the least split that gives eight warps an SM
    split = 1;
    while (split < 4 && split * 2 * groups <= kMaxWarps && split * 2 <= chunks &&
           blocks(rows) * groups * split < 8 * kSMs) {
      split *= 2;
    }
  }
  if ((rows != 16 && rows != 32 && rows != 64 && rows != 128) ||
      (split != 1 && split != 2 && split != 4) || split > chunks ||
      groups * split > kMaxWarps) {
    return false;
  }
  const int smem = plan_smem<T, D>(kernel, rows, split);
  if (smem > kSmemMax) return false;
  *p = {rows, split, cols, groups * split, smem, dim3((N + rows - 1) / rows, H, B)};
  return true;
}

template <typename T>
bool plan_t(int kernel, int B, int N, int H, int D, int rows, int split, Plan* p) {
  switch (D) {
    case 32: return plan_d<T, 32>(kernel, B, N, H, rows, split, p);
    case 64: return plan_d<T, 64>(kernel, B, N, H, rows, split, p);
    case 128: return plan_d<T, 128>(kernel, B, N, H, rows, split, p);
    default: return false;
  }
}

// One forward launch under plan p.
template <typename T, int D>
cudaError_t forward_d(const Plan& p, const void* q, const void* k, const void* v, void* out,
                      float* lse, int N, int H, float scale, cudaStream_t stream) {
  const cudaError_t err = allow_smem<flash_fwd_kernel<T, D>>(p.smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<p.grid, 32 * p.warps, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, N, H, scale, p.split);
  return cudaGetLastError();
}

// One backward launch: dK/dV into out0, out1, or dQ into out0 and di (from
// o).
template <typename T, int D>
cudaError_t backward_d(int kernel, const Plan& p, const void* q, const void* k, const void* v,
                       const void* dout, const void* o, const float* lse, float* di,
                       void* out0, void* out1, int N, int H, float scale, cudaStream_t stream) {
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const auto* tv = static_cast<const T*>(v);
  const auto* tdo = static_cast<const T*>(dout);
  if (kernel == kDkv) {
    const cudaError_t err = allow_smem<flash_bwd_dkv_kernel<T, D>>(p.smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T, D><<<p.grid, 32 * p.warps, p.smem, stream>>>(
        tq, tk, tv, tdo, lse, di, static_cast<T*>(out0), static_cast<T*>(out1), N, H, scale,
        p.split);
  } else {
    const cudaError_t err = allow_smem<flash_bwd_dq_kernel<T, D>>(p.smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, D><<<p.grid, 32 * p.warps, p.smem, stream>>>(
        tq, tk, tv, tdo, static_cast<const T*>(o), lse, di, static_cast<T*>(out0), N, H, scale,
        p.split);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(int rows, int split, const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int N, int H, int D, float scale, void* stream) {
  if (static_cast<long long>(B) * N * H == 0) return cudaSuccess;
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out))
    return cudaErrorMisalignedAddress;
  Plan p;
  if (!(scale > 0.0f) || !plan_t<T>(kForward, B, N, H, D, rows, split, &p))
    return cudaErrorInvalidValue;
  auto* l = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return forward_d<T, 32>(p, q, k, v, out, l, N, H, scale, st);
    case 64: return forward_d<T, 64>(p, q, k, v, out, l, N, H, scale, st);
    case 128: return forward_d<T, 128>(p, q, k, v, out, l, N, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t backward(int kernel, int rows, int split, const void* q, const void* k,
                     const void* v, const void* dout, const void* o, const void* lse, void* di,
                     void* out0, void* out1, int B, int N, int H, int D, float scale,
                     void* stream) {
  if (static_cast<long long>(B) * N * H == 0) return cudaSuccess;
  if (kernel == kDq && o == nullptr) return cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout) ||
      (kernel == kDq && misaligned(o))) {
    return cudaErrorMisalignedAddress;
  }
  Plan p;
  if ((kernel != kDkv && kernel != kDq) || !plan_t<T>(kernel, B, N, H, D, rows, split, &p)) {
    return cudaErrorInvalidValue;
  }
  auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<float*>(di);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return backward_d<T, 32>(kernel, p, q, k, v, dout, o, l, d, out0, out1, N, H, scale, st);
    case 64:
      return backward_d<T, 64>(kernel, p, q, k, v, dout, o, l, d, out0, out1, N, H, scale, st);
    case 128:
      return backward_d<T, 128>(kernel, p, q, k, v, dout, o, l, d, out0, out1, N, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, out [B, N, H, D]; lse [B, H, N] f32, or null when no gradient is
// wanted; scale > 0.
cudaError_t flash_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                          int B, int N, int H, int D, float scale, void* stream) {
  return forward<float>(0, 0, q, k, v, out, lse, B, N, H, D, scale, stream);
}

cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                           int B, int N, int H, int D, float scale, void* stream) {
  return forward<__nv_bfloat16>(0, 0, q, k, v, out, lse, B, N, H, D, scale, stream);
}

// dout, dk, dv [B, N, H, D]; lse and di = sum(out * dout, -1) [B, H, N] f32.
cudaError_t flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* di, void* dk, void* dv, int B, int N,
                              int H, int D, float scale, void* stream) {
  return backward<float>(kDkv, 0, 0, q, k, v, dout, nullptr, lse, const_cast<void*>(di), dk, dv,
                         B, N, H, D, scale, stream);
}

cudaError_t flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, void* dk, void* dv, int B, int N,
                               int H, int D, float scale, void* stream) {
  return backward<__nv_bfloat16>(kDkv, 0, 0, q, k, v, dout, nullptr, lse, const_cast<void*>(di),
                                 dk, dv, B, N, H, D, scale, stream);
}

// out [B, N, H, D], the forward's output: di = sum(out * dout, -1) [B, H, N]
// f32 is formed and written into di, for the dK/dV kernel.
cudaError_t flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                             const void* out, const void* lse, void* di, void* dq, int B, int N,
                             int H, int D, float scale, void* stream) {
  return backward<float>(kDq, 0, 0, q, k, v, dout, out, lse, di, dq, nullptr, B, N, H, D, scale,
                         stream);
}

cudaError_t flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                              const void* out, const void* lse, void* di, void* dq, int B, int N,
                              int H, int D, float scale, void* stream) {
  return backward<__nv_bfloat16>(kDq, 0, 0, q, k, v, dout, out, lse, di, dq, nullptr, B, N, H, D,
                                 scale, stream);
}

// A forward launch under a given plan (rows = split = 0 the default): what
// the plan's choice is timed from.
cudaError_t flash_fwd_planned(int bf16, int rows, int split, const void* q, const void* k,
                              const void* v, void* out, void* lse, int B, int N, int H, int D,
                              float scale, void* stream) {
  return bf16 ? forward<__nv_bfloat16>(rows, split, q, k, v, out, lse, B, N, H, D, scale, stream)
              : forward<float>(rows, split, q, k, v, out, lse, B, N, H, D, scale, stream);
}

// A backward launch under a given plan (kernel 1 dK/dV into out0 and out1,
// o unused; 2 dQ into out0, di as flash_bwd_dq_*; rows = split = 0 the
// default): what the plan's choice is timed from.
cudaError_t flash_bwd_planned(int kernel, int bf16, int rows, int split, const void* q,
                              const void* k, const void* v, const void* dout, const void* o,
                              const void* lse, void* di, void* out0, void* out1, int B, int N,
                              int H, int D, float scale, void* stream) {
  return bf16 ? backward<__nv_bfloat16>(kernel, rows, split, q, k, v, dout, o, lse, di, out0,
                                        out1, B, N, H, D, scale, stream)
              : backward<float>(kernel, rows, split, q, k, v, dout, o, lse, di, out0, out1, B, N,
                                H, D, scale, stream);
}

// The launch of kernel 0 (the forward), 1 (dK/dV) or 2 (dQ) at [B, N, H, D]
// in f32 or bf16 under rows and split (0 and 0: the default plan), into
// out[8]: rows a block, split, rows a staged tile, warps, grid x, y, z,
// dynamic shared memory in bytes. Returns 0, or -1 where the kernel does
// not take that plan.
int flash_attention_plan(int kernel, int B, int N, int H, int D, int bf16, int rows, int split,
                         int* out) {
  Plan p;
  if (kernel < kForward || kernel > kDq) return -1;
  const bool ok = bf16 ? plan_t<__nv_bfloat16>(kernel, B, N, H, D, rows, split, &p)
                       : plan_t<float>(kernel, B, N, H, D, rows, split, &p);
  if (!ok) return -1;
  const int fields[8] = {p.rows, p.split, p.cols, p.warps, static_cast<int>(p.grid.x),
                         static_cast<int>(p.grid.y), static_cast<int>(p.grid.z), p.smem};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
  return 0;
}

const char* flash_attention_error_string(cudaError_t err) { return cudaGetErrorString(err); }

}  // extern "C"
