// Linear attention, forward and backward, for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++.
//
//   out = phi(Q) (phi(K)^T V) / (phi(Q) . sum_n phi(K) + eps),  phi = elu + 1
//
// per batch element and head, on q, k, v, out laid out [B, N, H, D].
//
// The forward (linear_attention_{f32,bf16}) replaces the TPU kernel
// `linear_attention_pallas` (cv_diffusion_tpu/ops/pallas_attention.py:82).
// That kernel packs the heads into the TPU's 128 lanes, masks the cross-head
// blocks of one wide D x D accumulator and walks N on a sequential grid axis
// with kv carried in scratch from one step to the next. None of that carries
// over: the blocks of a GPU grid run in parallel and in no order.
//
// The backward (linear_attention_bwd_{f32,bf16}) replaces the closed-form VJP
// of `linear_attention_pallas_trainable` (`_trainable_bwd`,
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
// min(phi(x), 1), which never overflows for large x. eps is added before the
// square.
//
// What bounds them on an H100. At the serving shape [B, 1024, 4, 32] in f32
// one image is about 17.6 MFLOP (0.26 us at 67 TFLOP/s on the CUDA cores)
// against 2 MiB moved (q, k, v read once, out written once: 0.63 us at 3.35
// TB/s); the backward moves 7 tensors. So both are bound by bytes, and at
// batch 1 by the launch: one launch's fixed cost is more than the bytes
// bound. What they must do is a reduction over all N tokens of a (batch,
// head) -- kv and ksum, and in the backward d_kv and d_ksum -- before any
// output row can be written.
//
// The design: one launch each, no scratch in device memory, no atomics.
// The grid is (B*H) x C blocks of 256 threads, and the C blocks of one
// (batch, head) form a thread-block cluster: they run at once on neighbouring
// SMs and can write each other's shared memory. Rank r of a cluster owns
// `rows` consecutive tokens (the last rank the ragged rest, possibly none)
// and
//
//   1. loads k and v for its tokens with 16-byte loads, stages phi(k) and v
//      in shared memory as f32, and accumulates its partial kv [D x D] in
//      registers (each thread a 4x4 or 8x8 tile of kv, so one shared-memory
//      load feeds 4 or 8 FMAs; at D = 32 four groups of threads take every
//      fourth token and are summed in order) and its share of ksum [D];
//   2. reduce-scatter: pushes each 16-byte chunk of its partial into the
//      shared memory of the rank that owns the chunk (st.async, counted in
//      bytes on the owner's mbarrier), and meanwhile issues the loads of
//      its first tile of q, so that they are in flight during the reduction;
//   3. once its slice has come from every rank, sums it in rank order
//      0..C-1, and all-gather: copies the sums into every other rank in one
//      bulk copy each (cp.async.bulk, counted on their mbarrier). Each chunk
//      is summed once, by its owner, so every rank holds bit-identical kv
//      and ksum, and reruns are bit-identical;
//   4. once all of kv has come, writes phi(q) kv / (phi(q) . ksum + eps)
//      for its tokens in q's dtype, with 16-byte stores;
//   5. waits at a cluster barrier before it exits, which each rank passes
//      once its kv has landed: no block leaves while a copy out of its
//      shared memory may be running.
//
// No rank waits for the whole cluster inside the reduction, only for the
// bytes it is owed. The cluster barrier proper is used only around the
// mbarriers' set-up and at the exit, where it is off the critical path.
// (Measured on an H100: pulling every partial from every rank through
// distributed shared memory cost 2.4-3.5 us a reduction, two cluster
// barriers around pushed stores ~1.6 us more: PERF.md, Findings.)
//
// The backward runs the same layout with two cluster reductions: (1) kv and
// ksum as above; (2) per tile of its tokens, q and g are loaded, num, den,
// d_num, d_den and dq are computed and dq written, and the partial d_kv and
// d_ksum accumulated; the cluster reduces them the same way, on the
// mbarriers' second phases; (3) dk and dv from phi(k) and v. Each of q, k, v
// and g is read once and dq, dk, dv are written once when a rank's tokens fit
// one tile (every rank of the serving and training shapes); a rank with more
// tokens loops over tiles and re-reads k and v in step 3, from L2. At D = 128
// the tiles of four tensors and the [D x (D+1)] buffers fill the 227 KB of
// shared memory, so tiles are 16 rows there.
//
// C is 16 where the grid still has one block per SM (batch 1 at the serving
// shape: each rank's serial work halves), else at most 8; the plan is
// ops/linear_attention_kernel.py::plan.
//
// The products stay in f32 on the CUDA cores: one image is about 17.6 MFLOP,
// 0.26 us at 67 TFLOP/s, so the kernels are bound by bytes and launch, and
// tensor cores would buy nothing while costing the 2e-5 tolerance its margin
// (TF32 keeps 10 bits of mantissa).
//
// D is 32, 64 or 128; any N >= 1 and any H. Inputs are f32 or bf16 (16-byte
// aligned), accumulation is f32. The entry points launch on the caller's
// stream and return the cudaError_t of the launch; they allocate nothing. A
// cluster of C blocks must fit on the card (cudaOccupancyMaxActiveClusters,
// asked once per kernel and C): where none does, the launch returns
// cudaErrorLaunchOutOfResources and nothing runs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;          // floats after each staged row of a tile
constexpr int kMaxCluster = 16;  // C = 1, 2, 4, 8 or 16 (16: non-portable)

// Rows of q, k, v (and g) staged in shared memory at a time, by head dim:
// the forward's and the backward's tiles, and a short tile taken by both
// where a rank has at most that many tokens (0: none), so that its products
// keep every warp busy. ops/linear_attention_kernel.py::plan mirrors them.
template <int D> struct Tiles;
template <> struct Tiles<32> {
  static constexpr int kFwdRows = 128, kBwdRows = 128, kShortRows = 64;
};
template <> struct Tiles<64> { static constexpr int kFwdRows = 64, kBwdRows = 64, kShortRows = 0; };
template <> struct Tiles<128> { static constexpr int kFwdRows = 32, kBwdRows = 16, kShortRows = 0; };

template <int D> struct Dims {
  static constexpr int LD = D + kPad;     // staged row stride (floats)
  static constexpr int KV = D * (D + 1);  // a reduced buffer: kv [D][D], then ksum [D]
  static constexpr int KV4 = KV / 4;      // its float4 chunks
  // what the ranks push to one rank: C slices of ceil(KV4 / C) chunks
  static constexpr int RECV = KV + 4 * kMaxCluster;
};

constexpr int kBarrierFloats = 8;  // two mbarriers (8 bytes each), padded to 32 bytes

// Shared memory of a block with tiles of TR rows, in floats: forward bars |
// ks | vs | qs | recv | R; backward bars | ks | vs | qs | gs | dd | recv | R
// | RT. Before a reduction the token groups' partials and the column sums'
// parts go where ks and vs (forward) or qs and gs (backward) lie.
template <int D> constexpr int fwd_smem_floats(int TR) {
  return kBarrierFloats + 3 * TR * Dims<D>::LD + Dims<D>::RECV + Dims<D>::KV;
}
template <int D> constexpr int bwd_smem_floats(int TR) {
  return kBarrierFloats + 4 * TR * Dims<D>::LD + TR + Dims<D>::RECV + Dims<D>::KV + D * D;
}
static_assert(4 * bwd_smem_floats<128>(Tiles<128>::kBwdRows) <= 232448,
              "backward tiles exceed shared memory");

// The rows of the tiles a rank of `rows` tokens is staged in.
template <int D> int tile_rows(int rows, bool backward) {
  if (Tiles<D>::kShortRows > 0 && rows <= Tiles<D>::kShortRows) return Tiles<D>::kShortRows;
  return backward ? Tiles<D>::kBwdRows : Tiles<D>::kFwdRows;
}

__device__ __forceinline__ float phi(float x) { return x > 0.f ? x + 1.f : expf(x); }

// Inline PTX: the cluster barrier, mbarriers, and stores into another
// block's shared memory.

// The two halves of a cluster barrier: every thread of every block of the
// cluster arrives (releasing its earlier writes) and then waits (acquiring
// the others'). Work between them overlaps the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory location in block `rank` of the cluster.
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// An mbarrier that completes a phase on one arrival and its expected bytes.
__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of the barrier's current phase, with the bytes it awaits.
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Until the phase of this parity has completed.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes into another block's shared memory (cluster addresses from
// peer_addr), counted on that block's mbarrier when they land.
__device__ __forceinline__ void push(unsigned dst, unsigned bar, float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];" ::
          "r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// Orders this thread's shared-memory writes before later reads of the
// asynchronous proxy (the bulk copies below).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A bulk copy of `bytes` (a multiple of 16) from this block's shared memory
// into another's, counted on that block's mbarrier when it lands.
__device__ __forceinline__ void copy_to_peer(unsigned dst, unsigned src, unsigned bytes,
                                             unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// End of inline PTX.

// 16 bytes of T to floats: 4 f32 or 8 bf16 (bf16 -> f32 is exact).
__device__ __forceinline__ void to_floats(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void to_floats(const uint4& r, float* f, __nv_bfloat16) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&p);
}

// Loading a tile of TR rows of one head: 16-byte vectors, neighbouring threads
// on neighbouring addresses; rows past `rows` read nothing and stage zeros.
template <typename T, int D, int TR> struct TileIO {
  static constexpr int VN = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int VPR = D / VN;         // vectors per row
  static constexpr int ITERS = TR * VPR / kThreads;
  static_assert(TR * VPR % kThreads == 0, "a tile is a whole number of passes");

  __device__ static void fetch(uint4 (&r)[ITERS], const T* src, size_t row_stride, int rows) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int x = threadIdx.x + it * kThreads;
      const int row = x / VPR;
      const int c = (x - row * VPR) * VN;
      r[it] = row < rows ? *reinterpret_cast<const uint4*>(src + row * row_stride + c)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // f32 into a staged tile (row stride LD), with phi applied when Phi;
  // rows past `rows` are zero (not phi(0)).
  template <bool Phi>
  __device__ static void commit(const uint4 (&r)[ITERS], float* dst, int rows) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int x = threadIdx.x + it * kThreads;
      const int row = x / VPR;
      const int c = (x - row * VPR) * VN;
      float f[VN];
      to_floats(r[it], f, T());
#pragma unroll
      for (int e = 0; e < VN; ++e) f[e] = row < rows ? (Phi ? phi(f[e]) : f[e]) : 0.f;
#pragma unroll
      for (int e = 0; e < VN; e += 4)
        *reinterpret_cast<float4*>(dst + row * Dims<D>::LD + c + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
  }
};

// The partial sums over a rank's tokens: part[i][j] = sum_m A[m][i] B[m][j],
// part[D*D + i] = sum_m A[m][i] w[m] (w = 1 unweighted). Thread (g, ti, tj)
// holds a TI x TI tile of the products: rows and columns 4 (ti + NT c) .. + 3,
// c < TI / 4, over the tokens m = g, g + G, ... of each staged tile. Each
// thread also takes a share of the column sums: column t % D over every
// (kThreads / D)-th row.
template <int D> struct Reduce {
  static constexpr int TI = D >= 128 ? 8 : 4;
  static constexpr int NT = D / TI;
  static constexpr int G = kThreads / (NT * NT);  // token groups: 4 at D = 32
  static constexpr int IC = TI / 4;
  static constexpr int PARTS = kThreads / D;      // column-sum parts
  static_assert(G >= 1 && G * NT * NT == kThreads, "threads tile kv exactly");

  float acc[TI][TI];
  float col;

  __device__ void zero() {
    col = 0.f;
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TI; ++j) acc[i][j] = 0.f;
  }

  template <bool Weighted>
  __device__ void tile(const float* A, const float* B, const float* w, int rows) {
    const int t = threadIdx.x;
    const int g = t / (NT * NT);
    const int ti = (t / NT) % NT;
    const int tj = t % NT;
#pragma unroll 2
    for (int m = g; m < rows; m += G) {
      float a[TI], b[TI];
#pragma unroll
      for (int c = 0; c < IC; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(A + m * Dims<D>::LD + 4 * (ti + NT * c));
        const float4 y = *reinterpret_cast<const float4*>(B + m * Dims<D>::LD + 4 * (tj + NT * c));
        a[4 * c] = x.x; a[4 * c + 1] = x.y; a[4 * c + 2] = x.z; a[4 * c + 3] = x.w;
        b[4 * c] = y.x; b[4 * c + 1] = y.y; b[4 * c + 2] = y.z; b[4 * c + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TI; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    const int c = t % D;
#pragma unroll 4
    for (int m = t / D; m < rows; m += PARTS) {
      const float x = A[m * Dims<D>::LD + c];
      col = Weighted ? fmaf(x, w[m], col) : col + x;
    }
  }

  // Reduce-scatter, first half: this rank's partial, chunk by chunk, pushed
  // into the shared memory of the rank that owns the chunk (rank o owns
  // chunks [o S4, (o + 1) S4)), at recv[this rank][x - o S4], counted on that
  // rank's barrier `bar`. The token groups' tiles (D = 32) and the column
  // sums' parts are summed in order first, through `scratch` (G D^2 +
  // kThreads floats, or kThreads), which is free again on return.
  __device__ void scatter(unsigned recv, unsigned bar, float* scratch, int C, int rank) const {
    const int t = threadIdx.x;
    const int g = t / (NT * NT);
    const int ti = (t / NT) % NT;
    const int tj = t % NT;
    const int S4 = (Dims<D>::KV4 + C - 1) / C;
    auto send = [&](int x, float4 val) {
      const int owner = x / S4;
      push(peer_addr(recv + 16 * (rank * S4 + x - owner * S4), owner), peer_addr(bar, owner), val);
    };
    float* parts = scratch + (G > 1 ? G * D * D : 0);
    parts[t] = col;  // column t % D, part t / D
    if (G > 1) {
#pragma unroll
      for (int ci = 0; ci < IC; ++ci)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int cj = 0; cj < IC; ++cj) {
            const int i = 4 * ci + u;
            *reinterpret_cast<float4*>(scratch + g * D * D + (4 * (ti + NT * ci) + u) * D +
                                       4 * (tj + NT * cj)) =
                make_float4(acc[i][4 * cj], acc[i][4 * cj + 1], acc[i][4 * cj + 2],
                            acc[i][4 * cj + 3]);
          }
    }
    __syncthreads();
    if (G > 1) {
      for (int x = t; x < D * D / 4; x += kThreads) {
        float4 a = reinterpret_cast<const float4*>(scratch)[x];
#pragma unroll
        for (int k = 1; k < G; ++k) {
          const float4 y = reinterpret_cast<const float4*>(scratch + k * D * D)[x];
          a.x += y.x; a.y += y.y; a.z += y.z; a.w += y.w;
        }
        send(x, a);
      }
    } else {
#pragma unroll
      for (int ci = 0; ci < IC; ++ci)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int cj = 0; cj < IC; ++cj) {
            const int i = 4 * ci + u;
            send(((4 * (ti + NT * ci) + u) * D + 4 * (tj + NT * cj)) / 4,
                 make_float4(acc[i][4 * cj], acc[i][4 * cj + 1], acc[i][4 * cj + 2],
                             acc[i][4 * cj + 3]));
          }
    }
    for (int x = t; x < D / 4; x += kThreads) {
      float4 a = reinterpret_cast<const float4*>(parts)[x];
#pragma unroll
      for (int k = 1; k < PARTS; ++k) {
        const float4 y = reinterpret_cast<const float4*>(parts + k * D)[x];
        a.x += y.x; a.y += y.y; a.z += y.z; a.w += y.w;
      }
      send(D * D / 4 + x, a);
    }
    __syncthreads();  // scratch is free again
  }
};

// The chunks of kv (and ksum) that `rank` sums: [rank S4, rank S4 + n).
template <int D> __device__ int slice_chunks(int C, int rank) {
  const int S4 = (Dims<D>::KV4 + C - 1) / C;
  const int n = min(S4, Dims<D>::KV4 - rank * S4);
  return n > 0 ? n : 0;
}

// Reduce-scatter, second half, and all-gather: this rank sums each chunk of
// its slice over the ranks' contributions into its own R, then copies the
// slice into every other rank's R in one bulk copy each, counted on their
// barrier `bar`. A chunk's sum is taken by Q neighbouring lanes, lane q adding
// ranks 4q .. 4q + 3 in order, and the Q part sums are added as a fixed tree
// ((0 + 1) + (2 + 3)) by xor shuffles, which gives every lane the same bits.
// Each chunk is summed by one rank only, so every rank's R is bit-identical,
// and reruns are too. A rank that has this slice may push its next partial
// into recv: every read of recv comes before the copies (the block barrier
// between).
//
// sum_slice is the summing half, into `out` (shared memory, fenced for the
// copies, or device memory); gather adds the copies.
template <int D, bool Shared>
__device__ void sum_slice(const float* recv, float4* out, int C, int rank) {
  const int S4 = (Dims<D>::KV4 + C - 1) / C;
  const int x0 = rank * S4;
  const int n = slice_chunks<D>(C, rank);
  const int Q = C > 8 ? 4 : C > 4 ? 2 : 1;  // lanes a chunk
  const float4* in = reinterpret_cast<const float4*>(recv);
  const int lanes = (n * Q + 31) / 32 * 32;  // whole warps: every lane shuffles
  for (int p = threadIdx.x; p < lanes; p += kThreads) {
    const int j = p / Q;
    const int r0 = 4 * (p - j * Q);
    float4 part[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      part[u] = j < n && r0 + u < C ? in[(r0 + u) * S4 + j] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 a = part[0];
#pragma unroll
    for (int u = 1; u < 4; ++u)
      if (r0 + u < C) {
        a.x += part[u].x; a.y += part[u].y; a.z += part[u].z; a.w += part[u].w;
      }
    for (int m = 1; m < Q; m <<= 1) {
      a.x += __shfl_xor_sync(0xffffffffu, a.x, m);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, m);
      a.z += __shfl_xor_sync(0xffffffffu, a.z, m);
      a.w += __shfl_xor_sync(0xffffffffu, a.w, m);
    }
    if (j < n && r0 == 0) {
      out[x0 + j] = a;
      if constexpr (Shared) fence_async_shared();  // the sum, before the copies read it
    }
  }
}

template <int D>
__device__ void gather(const float* recv, float* R, unsigned bar, int C, int rank) {
  const int S4 = (Dims<D>::KV4 + C - 1) / C;
  const int x0 = rank * S4;
  const int n = slice_chunks<D>(C, rank);
  sum_slice<D, true>(recv, reinterpret_cast<float4*>(R), C, rank);
  __syncthreads();
  // one copy a warp: the copies of one warp's lanes are issued one by one
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x % 32;
  const int dst = threadIdx.x / 32 + kWarps * lane;
  if (lane < (C + kWarps - 1) / kWarps && dst < C && dst != rank && n > 0) {
    const unsigned slice = smem_addr(R) + 16 * x0;
    copy_to_peer(peer_addr(slice, dst), slice, 16 * n, peer_addr(bar, dst));
  }
}

// RT = the transpose of R's kv [D][D].
template <int D> __device__ void transpose(const float* R, float* RT) {
  for (int x = threadIdx.x; x < D * D / 4; x += kThreads) {
    const float4 a = reinterpret_cast<const float4*>(R)[x];
    const int i = 4 * x / D;
    const int j = 4 * x - i * D;
    RT[j * D + i] = a.x;
    RT[(j + 1) * D + i] = a.y;
    RT[(j + 2) * D + i] = a.z;
    RT[(j + 3) * D + i] = a.w;
  }
}

// Row-tile products out[n][col] = sum_i A[n][i] M[i][col] (A staged with
// stride LD, M [D][D]); with Den also den[n] = sum_i A[n][i] vec[i]. Thread
// (rg, cg) takes rows AR rg + a (a < AR) and 8 columns: for f32 two float4s
// at 4 (cg + CG c), for bf16 eight neighbours at 8 cg, so that each output
// row leaves in 16-byte stores. Threads whose rows all lie past a tile's
// live rows skip the product (whole warps of them, on a short tile).
template <typename T, int D, int TR> struct Product {
  static constexpr int CG = D / 8;
  static constexpr int RG = kThreads / CG;
  static constexpr int AR = TR / RG;
  static_assert(AR >= 1 && AR * RG == TR, "threads tile a row tile exactly");

  __device__ static int colgroup() { return threadIdx.x % CG; }
  __device__ static int row(int a) { return threadIdx.x / CG * AR + a; }
  __device__ static int col(int c) {  // first of the 4 columns of chunk c < 2
    return sizeof(T) == 4 ? 4 * (colgroup() + CG * c) : 8 * colgroup() + 4 * c;
  }

  template <bool Den>
  __device__ static void run(float (&out)[AR][8], float (&den)[AR], const float* A, const float* M,
                             const float* vec, int rows) {
    if (row(0) >= rows) return;
    const int c0 = col(0);
    const int c1 = col(1);
#pragma unroll 2
    for (int i = 0; i < D; i += 4) {
      float a[AR][4];
#pragma unroll
      for (int r = 0; r < AR; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(A + row(r) * Dims<D>::LD + i);
        a[r][0] = x.x; a[r][1] = x.y; a[r][2] = x.z; a[r][3] = x.w;
      }
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      if (Den) {
        const float4 x = *reinterpret_cast<const float4*>(vec + i);
        w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 m0 = *reinterpret_cast<const float4*>(M + (i + u) * D + c0);
        const float4 m1 = *reinterpret_cast<const float4*>(M + (i + u) * D + c1);
        const float m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
        for (int r = 0; r < AR; ++r) {
#pragma unroll
          for (int e = 0; e < 8; ++e) out[r][e] = fmaf(a[r][u], m[e], out[r][e]);
          if (Den) den[r] = fmaf(a[r][u], w[u], den[r]);
        }
      }
    }
  }

  // 8 values of one row at this thread's columns.
  __device__ static void store(float* dst, const float (&x)[8]) {
    *reinterpret_cast<float4*>(dst + col(0)) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(dst + col(1)) = make_float4(x[4], x[5], x[6], x[7]);
  }
  __device__ static void store(__nv_bfloat16* dst, const float (&x)[8]) {
    *reinterpret_cast<uint4*>(dst + col(0)) = make_uint4(
        pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  }
};

// A (batch, head) and this rank's tokens [n0, n0 + mine).
struct Span {
  size_t base;        // offset of (b, n = 0, h, 0)
  size_t row_stride;  // H * D
  int n0, mine;
};

__device__ __forceinline__ Span span_of(int C, int rank, int N, int H, int D, int rows) {
  const int bh = blockIdx.x / C;
  const int b = bh / H;
  const int h = bh - b * H;
  Span s;
  s.row_stride = static_cast<size_t>(H) * D;
  s.base = (static_cast<size_t>(b) * N * H + h) * D;
  const long long n0 = static_cast<long long>(rank) * rows;
  s.n0 = static_cast<int>(n0 < N ? n0 : N);
  s.mine = static_cast<int>((n0 + rows < N ? n0 + rows : N) - s.n0);
  return s;
}

// Step 1 of both kernels: this rank's partial kv and ksum over its tokens,
// tile by tile through ks and vs (which keep the last tile).
template <typename T, int D, int TR>
__device__ void reduce_kv(Reduce<D>& red, const T* k, const T* v, const Span& sp, float* ks,
                          float* vs) {
  using IO = TileIO<T, D, TR>;
  red.zero();
  for (int t0 = 0; t0 < sp.mine; t0 += TR) {
    const int rows = min(TR, sp.mine - t0);
    const size_t off = sp.base + static_cast<size_t>(sp.n0 + t0) * sp.row_stride;
    uint4 kr[IO::ITERS], vr[IO::ITERS];
    IO::fetch(kr, k + off, sp.row_stride, rows);
    IO::fetch(vr, v + off, sp.row_stride, rows);
    IO::template commit<true>(kr, ks, rows);
    IO::template commit<false>(vr, vs, rows);
    __syncthreads();
    red.template tile<false>(ks, vs, nullptr, rows);
    __syncthreads();
  }
}

// Three blocks share an SM at D = 32 (at most 80 registers a thread), two up
// to D = 64 (128): the batch-8 grid then runs in one wave.
template <typename T, int D, int TR>
__global__ void __launch_bounds__(kThreads, D == 32 ? 3 : D == 64 ? 2 : 1)
linear_attention_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int N, int H, int rows, float eps) {
  constexpr int LD = Dims<D>::LD;
  static_assert(2 * TR * LD >= (Reduce<D>::G > 1 ? Reduce<D>::G * D * D : 0) + kThreads,
                "the reduction's scratch fits in ks and vs");
  using IO = TileIO<T, D, TR>;
  using Pr = Product<T, D, TR>;
  extern __shared__ __align__(16) float smem[];
  const unsigned bar_rs = smem_addr(smem);      // the reduce-scatter's bytes
  const unsigned bar_ag = bar_rs + 8;           // the all-gather's
  float* ks = smem + kBarrierFloats;
  float* vs = ks + TR * LD;
  float* qs = vs + TR * LD;
  float* recv = qs + TR * LD;
  float* R = recv + Dims<D>::RECV;

  const cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Span sp = span_of(C, rank, N, H, D, rows);
  if (threadIdx.x == 0) {
    bar_init(bar_rs);
    bar_init(bar_ag);
  }
  cluster_arrive();  // the barriers exist before any rank pushes to them

  Reduce<D> red;
  reduce_kv<T, D, TR>(red, k, v, sp, ks, vs);
  cluster_wait();
  if (threadIdx.x == 0) bar_expect(bar_rs, 16u * C * slice_chunks<D>(C, rank));
  red.scatter(smem_addr(recv), bar_rs, ks, C, rank);
  // the first tile of q is in flight across the reduction
  uint4 qr[IO::ITERS];
  IO::fetch(qr, q + sp.base + static_cast<size_t>(sp.n0) * sp.row_stride, sp.row_stride,
            min(TR, sp.mine));
  bar_wait(bar_rs, 0);
  if (threadIdx.x == 0) bar_expect(bar_ag, 16u * (Dims<D>::KV4 - slice_chunks<D>(C, rank)));
  gather<D>(recv, R, bar_ag, C, rank);
  IO::template commit<true>(qr, qs, min(TR, sp.mine));
  bar_wait(bar_ag, 0);  // R is whole, and no rank writes here any more
  cluster_arrive_relaxed();  // every copy into this block has landed: their sources may leave

  for (int t0 = 0; t0 < sp.mine; t0 += TR) {
    const int rows_t = min(TR, sp.mine - t0);
    const size_t off = sp.base + static_cast<size_t>(sp.n0 + t0) * sp.row_stride;
    if (t0 > 0) {
      IO::fetch(qr, q + off, sp.row_stride, rows_t);
      IO::template commit<true>(qr, qs, rows_t);
    }
    __syncthreads();  // the tile: an mbarrier wait orders no thread's commit for another
    float o[Pr::AR][8] = {};
    float den[Pr::AR] = {};
    Pr::template run<true>(o, den, qs, R, R + D * D, rows_t);
#pragma unroll
    for (int a = 0; a < Pr::AR; ++a) {
      const int row = Pr::row(a);
      if (row < rows_t) {
        const float d = den[a] + eps;
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = o[a][e] / d;
        Pr::store(out + off + row * sp.row_stride, x);
      }
    }
    __syncthreads();
  }
  cluster_wait();  // no block leaves while a copy out of its R may be running
}

// Two blocks share an SM up to D = 64 (at most 128 registers a thread).
template <typename T, int D, int TR>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
linear_attention_bwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
                     T* __restrict__ dv, int N, int H, int rows, float eps) {
  constexpr int LD = Dims<D>::LD;
  constexpr int KV = Dims<D>::KV;
  static_assert(2 * TR * LD >= (Reduce<D>::G > 1 ? Reduce<D>::G * D * D : 0) + kThreads,
                "the reduction's scratch fits in qs and gs");
  using IO = TileIO<T, D, TR>;
  using Pr = Product<T, D, TR>;
  extern __shared__ __align__(16) float smem[];
  const unsigned bar_rs = smem_addr(smem);      // the reduce-scatters' bytes
  const unsigned bar_ag = bar_rs + 8;           // the all-gathers'
  float* ks = smem + kBarrierFloats;
  float* vs = ks + TR * LD;
  float* qs = vs + TR * LD;
  float* gs = qs + TR * LD;
  float* dd = gs + TR * LD;  // d_den of the tile's rows
  float* recv = dd + TR;
  float* R = recv + Dims<D>::RECV;  // kv, then d_kv (ksum, then d_ksum, after them)
  float* RT = R + KV;               // kv^T, then d_kv^T

  const cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Span sp = span_of(C, rank, N, H, D, rows);

  if (threadIdx.x == 0) {
    bar_init(bar_rs);
    bar_init(bar_ag);
  }
  cluster_arrive();  // the barriers exist before any rank pushes to them

  // 1. kv and ksum over the cluster; the first tiles of q and g in flight
  Reduce<D> red;
  reduce_kv<T, D, TR>(red, k, v, sp, ks, vs);
  cluster_wait();
  if (threadIdx.x == 0) bar_expect(bar_rs, 16u * C * slice_chunks<D>(C, rank));
  red.scatter(smem_addr(recv), bar_rs, qs, C, rank);
  uint4 qr[IO::ITERS], gr[IO::ITERS];
  IO::fetch(qr, q + sp.base + static_cast<size_t>(sp.n0) * sp.row_stride, sp.row_stride,
            min(TR, sp.mine));
  IO::fetch(gr, g + sp.base + static_cast<size_t>(sp.n0) * sp.row_stride, sp.row_stride,
            min(TR, sp.mine));
  bar_wait(bar_rs, 0);
  if (threadIdx.x == 0) bar_expect(bar_ag, 16u * (Dims<D>::KV4 - slice_chunks<D>(C, rank)));
  gather<D>(recv, R, bar_ag, C, rank);
  IO::template commit<true>(qr, qs, min(TR, sp.mine));
  IO::template commit<false>(gr, gs, min(TR, sp.mine));
  bar_wait(bar_ag, 0);
  transpose<D>(R, RT);

  // 2. per tile: num, den, d_num, d_den, dq; the partial d_kv and d_ksum
  red.zero();
  for (int t0 = 0; t0 < sp.mine; t0 += TR) {
    const int rows_t = min(TR, sp.mine - t0);
    const size_t off = sp.base + static_cast<size_t>(sp.n0 + t0) * sp.row_stride;
    if (t0 > 0) {
      IO::fetch(qr, q + off, sp.row_stride, rows_t);
      IO::fetch(gr, g + off, sp.row_stride, rows_t);
      IO::template commit<true>(qr, qs, rows_t);
      IO::template commit<false>(gr, gs, rows_t);
    }
    __syncthreads();  // the tiles (an mbarrier wait orders no commit for another thread), RT
    {
      float num[Pr::AR][8] = {};
      float den[Pr::AR] = {};
      Pr::template run<true>(num, den, qs, R, R + D * D, rows_t);
#pragma unroll
      for (int a = 0; a < Pr::AR; ++a) {
        const int row = Pr::row(a);
        const float d = den[a] + eps;  // eps before the square
        float sg = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* gp = gs + row * LD + Pr::col(c);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            sg = fmaf(gp[u], num[a][4 * c + u], sg);
            gp[u] = gp[u] / d;  // d_num over g, this thread's columns only
          }
        }
#pragma unroll
        for (int m = Pr::CG / 2; m > 0; m >>= 1) sg += __shfl_xor_sync(0xffffffffu, sg, m);
        if (Pr::colgroup() == 0) dd[row] = -sg / (d * d);  // zero on rows past the tile
      }
    }
    __syncthreads();
    {
      float acc[Pr::AR][8] = {};
      float unused[Pr::AR];
      Pr::template run<false>(acc, unused, gs, RT, nullptr, rows_t);
#pragma unroll
      for (int a = 0; a < Pr::AR; ++a) {
        const int row = Pr::row(a);
        if (row < rows_t) {
          float x[8];
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int col = Pr::col(c) + u;
              x[4 * c + u] = fmaf(dd[row], R[D * D + col], acc[a][4 * c + u]) *
                             fminf(qs[row * LD + col], 1.f);
            }
          Pr::store(dq + off + row * sp.row_stride, x);
        }
      }
    }
    red.template tile<true>(qs, gs, dd, rows_t);
    __syncthreads();
  }

  // d_kv and d_ksum over the cluster, on the barriers' second phases. No
  // push lands early: a rank's recv is written only by ranks that have its
  // all-gather, which it sends after reading recv; its R only by owners that
  // have all its second partials, which it sends after step 2 (scatter
  // pushes only after a block barrier).
  if (threadIdx.x == 0) bar_expect(bar_rs, 16u * C * slice_chunks<D>(C, rank));
  red.scatter(smem_addr(recv), bar_rs, qs, C, rank);
  bar_wait(bar_rs, 1);
  if (threadIdx.x == 0) bar_expect(bar_ag, 16u * (Dims<D>::KV4 - slice_chunks<D>(C, rank)));
  gather<D>(recv, R, bar_ag, C, rank);
  bar_wait(bar_ag, 1);  // R is whole, and no rank writes here any more
  cluster_arrive_relaxed();  // every copy into this block has landed: their sources may leave
  transpose<D>(R, RT);

  // 3. dk and dv; a rank whose tokens fit one tile still holds phi(k) and v
  for (int t0 = 0; t0 < sp.mine; t0 += TR) {
    const int rows_t = min(TR, sp.mine - t0);
    const size_t off = sp.base + static_cast<size_t>(sp.n0 + t0) * sp.row_stride;
    if (sp.mine > TR) {
      uint4 kr[IO::ITERS], vr[IO::ITERS];
      IO::fetch(kr, k + off, sp.row_stride, rows_t);
      IO::fetch(vr, v + off, sp.row_stride, rows_t);
      IO::template commit<true>(kr, ks, rows_t);
      IO::template commit<false>(vr, vs, rows_t);
    }
    __syncthreads();  // the tiles, and on the first pass RT
    float ak[Pr::AR][8] = {};
    float av[Pr::AR][8] = {};
    float unused[Pr::AR];
    Pr::template run<false>(ak, unused, vs, RT, nullptr, rows_t);
    Pr::template run<false>(av, unused, ks, R, nullptr, rows_t);
#pragma unroll
    for (int a = 0; a < Pr::AR; ++a) {
      const int row = Pr::row(a);
      if (row < rows_t) {
        float x[8];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int col = Pr::col(c) + u;
            x[4 * c + u] = (ak[a][4 * c + u] + R[D * D + col]) * fminf(ks[row * LD + col], 1.f);
          }
        Pr::store(dk + off + row * sp.row_stride, x);
        Pr::store(dv + off + row * sp.row_stride, av[a]);
      }
    }
    __syncthreads();
  }
  cluster_wait();  // no block leaves while a copy out of its R may be running
}

// The token-sharded entries: the sequence of a (batch, head) is split over
// the ranks of a process group (the spatial axis of a UNet sharded by image
// rows), so kv and ksum, and in the backward d_kv and d_ksum, are sums over
// tokens that other processes hold. Each reduction therefore stops at device
// memory: `kv` and `bwd_partial` leave this process's sums there, float32,
// [B, H, D (D + 1)] (kv row-major [D][D], then ksum [D]: the layout of R), the
// caller adds them over the group (an all_reduce), and `apply` and
// `bwd_finish` take the reduced sums. The counterpart in the JAX package is
// the partitioner's psum form of `linear_attention_xla` and
// `linear_attention_sharded` (cv_diffusion_tpu/ops/attention.py:51-78,
// 100-136). `kv` and `bwd_partial` reduce over their own tokens with the
// cluster reduction above (reduce-scatter into the slices' owners, each owner
// writing its slice); `apply` and `bwd_finish` are row-parallel and run C
// blocks a (batch, head) with no cluster, each staging the reduced sums from
// device memory. Each moves its tokens' tensors once, as the fused kernels do.

// kv and ksum over this process's tokens, into kvs.
template <typename T, int D, int TR>
__global__ void __launch_bounds__(kThreads, D == 32 ? 3 : D == 64 ? 2 : 1)
linear_attention_kv(const T* __restrict__ k, const T* __restrict__ v, float* __restrict__ kvs,
                    int N, int H, int rows) {
  constexpr int LD = Dims<D>::LD;
  static_assert(2 * TR * LD >= (Reduce<D>::G > 1 ? Reduce<D>::G * D * D : 0) + kThreads,
                "the reduction's scratch fits in ks and vs");
  extern __shared__ __align__(16) float smem[];
  const unsigned bar_rs = smem_addr(smem);
  float* ks = smem + kBarrierFloats;
  float* vs = ks + TR * LD;
  float* recv = vs + TR * LD;

  const cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Span sp = span_of(C, rank, N, H, D, rows);
  if (threadIdx.x == 0) bar_init(bar_rs);
  cluster_arrive();  // the barrier exists before any rank pushes to it

  Reduce<D> red;
  reduce_kv<T, D, TR>(red, k, v, sp, ks, vs);
  cluster_wait();
  if (threadIdx.x == 0) bar_expect(bar_rs, 16u * C * slice_chunks<D>(C, rank));
  red.scatter(smem_addr(recv), bar_rs, ks, C, rank);
  bar_wait(bar_rs, 0);  // every rank's part of this slice has landed
  cluster_arrive_relaxed();
  sum_slice<D, false>(recv, reinterpret_cast<float4*>(kvs + static_cast<size_t>(blockIdx.x / C) *
                                                                Dims<D>::KV),
                      C, rank);
  cluster_wait();  // no block leaves while another may still push to it
}

// R = a [D (D + 1)] buffer of device memory (kvs of this block's (batch,
// head)), staged in shared memory.
template <int D> __device__ void stage_sums(float* R, const float* src) {
  for (int x = threadIdx.x; x < Dims<D>::KV4; x += kThreads)
    reinterpret_cast<float4*>(R)[x] = reinterpret_cast<const float4*>(src)[x];
}

// out = phi(q) kv / (phi(q) . ksum + eps) from the reduced kvs; C blocks a
// (batch, head), block rank r taking tokens [r rows, (r + 1) rows).
template <typename T, int D, int TR>
__global__ void __launch_bounds__(kThreads, D == 32 ? 3 : D == 64 ? 2 : 1)
linear_attention_apply(const T* __restrict__ q, const float* __restrict__ kvs,
                       T* __restrict__ out, int N, int H, int C, int rows, float eps) {
  using IO = TileIO<T, D, TR>;
  using Pr = Product<T, D, TR>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* R = qs + TR * Dims<D>::LD;
  const int rank = static_cast<int>(blockIdx.x % C);
  const Span sp = span_of(C, rank, N, H, D, rows);
  stage_sums<D>(R, kvs + static_cast<size_t>(blockIdx.x / C) * Dims<D>::KV);
  for (int t0 = 0; t0 < sp.mine; t0 += TR) {
    const int rows_t = min(TR, sp.mine - t0);
    const size_t off = sp.base + static_cast<size_t>(sp.n0 + t0) * sp.row_stride;
    uint4 qr[IO::ITERS];
    IO::fetch(qr, q + off, sp.row_stride, rows_t);
    IO::template commit<true>(qr, qs, rows_t);
    __syncthreads();  // the tile, and on the first pass R
    float o[Pr::AR][8] = {};
    float den[Pr::AR] = {};
    Pr::template run<true>(o, den, qs, R, R + D * D, rows_t);
#pragma unroll
    for (int a = 0; a < Pr::AR; ++a) {
      const int row = Pr::row(a);
      if (row < rows_t) {
        const float d = den[a] + eps;
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = o[a][e] / d;
        Pr::store(out + off + row * sp.row_stride, x);
      }
    }
    __syncthreads();
  }
}

// Step 2 of the backward from the reduced kvs: dq, written, and the partial
// d_kv and d_ksum over this process's tokens, into dkvs.
template <typename T, int D, int TR>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
linear_attention_bwd_partial(const T* __restrict__ q, const T* __restrict__ g,
                             const float* __restrict__ kvs, T* __restrict__ dq,
                             float* __restrict__ dkvs, int N, int H, int rows, float eps) {
  constexpr int LD = Dims<D>::LD;
  static_assert(2 * TR * LD >= (Reduce<D>::G > 1 ? Reduce<D>::G * D * D : 0) + kThreads,
                "the reduction's scratch fits in qs and gs");
  using IO = TileIO<T, D, TR>;
  using Pr = Product<T, D, TR>;
  extern __shared__ __align__(16) float smem[];
  const unsigned bar_rs = smem_addr(smem);
  float* qs = smem + kBarrierFloats;
  float* gs = qs + TR * LD;
  float* dd = gs + TR * LD;  // d_den of the tile's rows
  float* recv = dd + TR;
  float* R = recv + Dims<D>::RECV;  // kv, then ksum
  float* RT = R + Dims<D>::KV;      // kv^T

  const cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Span sp = span_of(C, rank, N, H, D, rows);
  if (threadIdx.x == 0) bar_init(bar_rs);
  cluster_arrive();  // the barrier exists before any rank pushes to it
  stage_sums<D>(R, kvs + static_cast<size_t>(blockIdx.x / C) * Dims<D>::KV);
  __syncthreads();
  transpose<D>(R, RT);

  Reduce<D> red;
  red.zero();
  for (int t0 = 0; t0 < sp.mine; t0 += TR) {
    const int rows_t = min(TR, sp.mine - t0);
    const size_t off = sp.base + static_cast<size_t>(sp.n0 + t0) * sp.row_stride;
    uint4 qr[IO::ITERS], gr[IO::ITERS];
    IO::fetch(qr, q + off, sp.row_stride, rows_t);
    IO::fetch(gr, g + off, sp.row_stride, rows_t);
    IO::template commit<true>(qr, qs, rows_t);
    IO::template commit<false>(gr, gs, rows_t);
    __syncthreads();  // the tiles, and on the first pass RT
    {
      float num[Pr::AR][8] = {};
      float den[Pr::AR] = {};
      Pr::template run<true>(num, den, qs, R, R + D * D, rows_t);
#pragma unroll
      for (int a = 0; a < Pr::AR; ++a) {
        const int row = Pr::row(a);
        const float d = den[a] + eps;  // eps before the square
        float sg = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* gp = gs + row * LD + Pr::col(c);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            sg = fmaf(gp[u], num[a][4 * c + u], sg);
            gp[u] = gp[u] / d;  // d_num over g, this thread's columns only
          }
        }
#pragma unroll
        for (int m = Pr::CG / 2; m > 0; m >>= 1) sg += __shfl_xor_sync(0xffffffffu, sg, m);
        if (Pr::colgroup() == 0) dd[row] = -sg / (d * d);  // zero on rows past the tile
      }
    }
    __syncthreads();
    {
      float acc[Pr::AR][8] = {};
      float unused[Pr::AR];
      Pr::template run<false>(acc, unused, gs, RT, nullptr, rows_t);
#pragma unroll
      for (int a = 0; a < Pr::AR; ++a) {
        const int row = Pr::row(a);
        if (row < rows_t) {
          float x[8];
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int col = Pr::col(c) + u;
              x[4 * c + u] = fmaf(dd[row], R[D * D + col], acc[a][4 * c + u]) *
                             fminf(qs[row * LD + col], 1.f);
            }
          Pr::store(dq + off + row * sp.row_stride, x);
        }
      }
    }
    red.template tile<true>(qs, gs, dd, rows_t);
    __syncthreads();
  }
  cluster_wait();
  if (threadIdx.x == 0) bar_expect(bar_rs, 16u * C * slice_chunks<D>(C, rank));
  red.scatter(smem_addr(recv), bar_rs, qs, C, rank);
  bar_wait(bar_rs, 0);
  cluster_arrive_relaxed();
  sum_slice<D, false>(recv, reinterpret_cast<float4*>(dkvs + static_cast<size_t>(blockIdx.x / C) *
                                                                 Dims<D>::KV),
                      C, rank);
  cluster_wait();  // no block leaves while another may still push to it
}

// Step 3 of the backward from the reduced dkvs: dk = (v d_kv^T + d_ksum) *
// phi'(k), dv = phi(k) d_kv; C blocks a (batch, head), no cluster.
template <typename T, int D, int TR>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
linear_attention_bwd_finish(const T* __restrict__ k, const T* __restrict__ v,
                            const float* __restrict__ dkvs, T* __restrict__ dk,
                            T* __restrict__ dv, int N, int H, int C, int rows) {
  constexpr int LD = Dims<D>::LD;
  using IO = TileIO<T, D, TR>;
  using Pr = Product<T, D, TR>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + TR * LD;
  float* R = vs + TR * LD;      // d_kv, then d_ksum
  float* RT = R + Dims<D>::KV;  // d_kv^T
  const int rank = static_cast<int>(blockIdx.x % C);
  const Span sp = span_of(C, rank, N, H, D, rows);
  stage_sums<D>(R, dkvs + static_cast<size_t>(blockIdx.x / C) * Dims<D>::KV);
  __syncthreads();
  transpose<D>(R, RT);
  for (int t0 = 0; t0 < sp.mine; t0 += TR) {
    const int rows_t = min(TR, sp.mine - t0);
    const size_t off = sp.base + static_cast<size_t>(sp.n0 + t0) * sp.row_stride;
    uint4 kr[IO::ITERS], vr[IO::ITERS];
    IO::fetch(kr, k + off, sp.row_stride, rows_t);
    IO::fetch(vr, v + off, sp.row_stride, rows_t);
    IO::template commit<true>(kr, ks, rows_t);
    IO::template commit<false>(vr, vs, rows_t);
    __syncthreads();  // the tiles, and on the first pass RT
    float ak[Pr::AR][8] = {};
    float av[Pr::AR][8] = {};
    float unused[Pr::AR];
    Pr::template run<false>(ak, unused, vs, RT, nullptr, rows_t);
    Pr::template run<false>(av, unused, ks, R, nullptr, rows_t);
#pragma unroll
    for (int a = 0; a < Pr::AR; ++a) {
      const int row = Pr::row(a);
      if (row < rows_t) {
        float x[8];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int col = Pr::col(c) + u;
            x[4 * c + u] = (ak[a][4 * c + u] + R[D * D + col]) * fminf(ks[row * LD + col], 1.f);
          }
        Pr::store(dk + off + row * sp.row_stride, x);
        Pr::store(dv + off + row * sp.row_stride, av[a]);
      }
    }
    __syncthreads();
  }
}

// Once per kernel instance, before its first launch (so that a CUDA graph
// capture of a later call holds no such call): its shared memory above 48 KB
// and clusters of 16; and once per C, whether a cluster of C fits at all.
template <auto Kernel>
cudaError_t prepare(const cudaLaunchConfig_t& cfg, int C) {
  static bool attributes = false;
  static int fits[5] = {-1, -1, -1, -1, -1};  // active clusters, by log2 C
  if (!attributes) {
    cudaError_t err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(cfg.dynamicSmemBytes));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    attributes = true;
  }
  const int lg = C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2 : C == 8 ? 3 : 4;
  if (fits[lg] < 0) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, Kernel, &cfg);
    if (err != cudaSuccess) return err;
    fits[lg] = n;
  }
  return fits[lg] > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

template <auto Kernel, typename... Args>
cudaError_t launch(int clusters, int C, int smem_floats, void* stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * smem_floats;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = prepare<Kernel>(cfg, C);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool valid(int B, int N, int H, int C, int rows) {
  const bool pow2 = C == 1 || C == 2 || C == 4 || C == 8 || C == kMaxCluster;
  return B > 0 && N > 0 && H > 0 && rows > 0 && pow2 &&
         static_cast<long long>(C) * rows >= N &&
         static_cast<long long>(B) * H * C <= 0x7fffffffLL;
}

template <typename T, int D>
cudaError_t forward_d(const T* q, const T* k, const T* v, T* out, int B, int N, int H, int C,
                      int rows, float eps, void* stream) {
  if constexpr (Tiles<D>::kShortRows > 0) {
    constexpr int TR = Tiles<D>::kShortRows;
    if (rows <= TR)
      return launch<linear_attention_fwd<T, D, TR>>(B * H, C, fwd_smem_floats<D>(TR), stream, q, k,
                                                    v, out, N, H, rows, eps);
  }
  constexpr int TR = Tiles<D>::kFwdRows;
  return launch<linear_attention_fwd<T, D, TR>>(B * H, C, fwd_smem_floats<D>(TR), stream, q, k, v,
                                                out, N, H, rows, eps);
}

template <typename T>
cudaError_t forward(const void* q, const void* k, const void* v, void* out, int B, int N, int H,
                    int D, int C, int rows, float eps, void* stream) {
  if (!valid(B, N, H, C, rows)) return cudaErrorInvalidValue;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* o = static_cast<T*>(out);
  switch (D) {
    case 32: return forward_d<T, 32>(qq, kk, vv, o, B, N, H, C, rows, eps, stream);
    case 64: return forward_d<T, 64>(qq, kk, vv, o, B, N, H, C, rows, eps, stream);
    case 128: return forward_d<T, 128>(qq, kk, vv, o, B, N, H, C, rows, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t backward_d(const T* const (&in)[4], T* const (&o)[3], int B, int N, int H, int C,
                       int rows, float eps, void* stream) {
  if constexpr (Tiles<D>::kShortRows > 0) {
    constexpr int TR = Tiles<D>::kShortRows;
    if (rows <= TR)
      return launch<linear_attention_bwd<T, D, TR>>(B * H, C, bwd_smem_floats<D>(TR), stream,
                                                    in[0], in[1], in[2], in[3], o[0], o[1], o[2],
                                                    N, H, rows, eps);
  }
  constexpr int TR = Tiles<D>::kBwdRows;
  return launch<linear_attention_bwd<T, D, TR>>(B * H, C, bwd_smem_floats<D>(TR), stream, in[0],
                                                in[1], in[2], in[3], o[0], o[1], o[2], N, H, rows,
                                                eps);
}

template <typename T>
cudaError_t backward(const void* q, const void* k, const void* v, const void* g, void* dq,
                     void* dk, void* dv, int B, int N, int H, int D, int C, int rows, float eps,
                     void* stream) {
  if (!valid(B, N, H, C, rows)) return cudaErrorInvalidValue;
  const T* const in[4] = {static_cast<const T*>(q), static_cast<const T*>(k),
                          static_cast<const T*>(v), static_cast<const T*>(g)};
  T* const o[3] = {static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv)};
  switch (D) {
    case 32: return backward_d<T, 32>(in, o, B, N, H, C, rows, eps, stream);
    case 64: return backward_d<T, 64>(in, o, B, N, H, C, rows, eps, stream);
    case 128: return backward_d<T, 128>(in, o, B, N, H, C, rows, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}


// The token-sharded entries' launches: a (batch, head) is a cluster of C for
// kv and bwd_partial, C independent blocks for apply and bwd_finish. The
// forward pair takes the forward's tiles, the backward pair the backward's.
enum class Sharded { kKv, kApply, kBwdPartial, kBwdFinish };

template <Sharded E, int D> constexpr int sharded_smem_floats(int TR) {
  if constexpr (E == Sharded::kKv) return kBarrierFloats + 2 * TR * Dims<D>::LD + Dims<D>::RECV;
  if constexpr (E == Sharded::kApply) return TR * Dims<D>::LD + Dims<D>::KV;
  if constexpr (E == Sharded::kBwdPartial)
    return kBarrierFloats + 2 * TR * Dims<D>::LD + TR + Dims<D>::RECV + Dims<D>::KV + D * D;
  return 2 * TR * Dims<D>::LD + Dims<D>::KV + D * D;
}

template <Sharded E, typename T, int D, int TR>
cudaError_t sharded_tile(const void* const (&in)[3], void* const (&o)[2], int B, int N, int H,
                         int C, int rows, float eps, void* stream) {
  constexpr int smem = sharded_smem_floats<E, D>(TR);
  const T* a = static_cast<const T*>(in[0]);
  if constexpr (E == Sharded::kKv)
    return launch<linear_attention_kv<T, D, TR>>(B * H, C, smem, stream, a,
                                                 static_cast<const T*>(in[1]),
                                                 static_cast<float*>(o[0]), N, H, rows);
  if constexpr (E == Sharded::kApply)
    return launch<linear_attention_apply<T, D, TR>>(B * H * C, 1, smem, stream, a,
                                                    static_cast<const float*>(in[1]),
                                                    static_cast<T*>(o[0]), N, H, C, rows, eps);
  if constexpr (E == Sharded::kBwdPartial)
    return launch<linear_attention_bwd_partial<T, D, TR>>(
        B * H, C, smem, stream, a, static_cast<const T*>(in[1]),
        static_cast<const float*>(in[2]), static_cast<T*>(o[0]), static_cast<float*>(o[1]), N, H,
        rows, eps);
  if constexpr (E == Sharded::kBwdFinish)
    return launch<linear_attention_bwd_finish<T, D, TR>>(
        B * H * C, 1, smem, stream, a, static_cast<const T*>(in[1]),
        static_cast<const float*>(in[2]), static_cast<T*>(o[0]), static_cast<T*>(o[1]), N, H, C,
        rows);
}

template <Sharded E, typename T, int D>
cudaError_t sharded_d(const void* const (&in)[3], void* const (&o)[2], int B, int N, int H, int C,
                      int rows, float eps, void* stream) {
  constexpr bool backward = E == Sharded::kBwdPartial || E == Sharded::kBwdFinish;
  if constexpr (Tiles<D>::kShortRows > 0) {
    constexpr int TR = Tiles<D>::kShortRows;
    if (rows <= TR) return sharded_tile<E, T, D, TR>(in, o, B, N, H, C, rows, eps, stream);
  }
  constexpr int TR = backward ? Tiles<D>::kBwdRows : Tiles<D>::kFwdRows;
  return sharded_tile<E, T, D, TR>(in, o, B, N, H, C, rows, eps, stream);
}

template <Sharded E, typename T>
cudaError_t sharded(const void* a, const void* b, const void* c, void* o0, void* o1, int B, int N,
                    int H, int D, int C, int rows, float eps, void* stream) {
  if (!valid(B, N, H, C, rows)) return cudaErrorInvalidValue;
  const void* const in[3] = {a, b, c};
  void* const o[2] = {o0, o1};
  switch (D) {
    case 32: return sharded_d<E, T, 32>(in, o, B, N, H, C, rows, eps, stream);
    case 64: return sharded_d<E, T, 64>(in, o, B, N, H, C, rows, eps, stream);
    case 128: return sharded_d<E, T, 128>(in, o, B, N, H, C, rows, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, out [B, N, H, D]; C blocks a cluster, one cluster per (batch,
// head); rank r takes tokens [r * rows, (r + 1) * rows) of N.
cudaError_t linear_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                                 int N, int H, int D, int C, int rows, float eps, void* stream) {
  return forward<float>(q, k, v, out, B, N, H, D, C, rows, eps, stream);
}

cudaError_t linear_attention_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                  int N, int H, int D, int C, int rows, float eps, void* stream) {
  return forward<__nv_bfloat16>(q, k, v, out, B, N, H, D, C, rows, eps, stream);
}

cudaError_t linear_attention_bwd_f32(const void* q, const void* k, const void* v, const void* g,
                                     void* dq, void* dk, void* dv, int B, int N, int H, int D,
                                     int C, int rows, float eps, void* stream) {
  return backward<float>(q, k, v, g, dq, dk, dv, B, N, H, D, C, rows, eps, stream);
}

cudaError_t linear_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* g,
                                      void* dq, void* dk, void* dv, int B, int N, int H, int D,
                                      int C, int rows, float eps, void* stream) {
  return backward<__nv_bfloat16>(q, k, v, g, dq, dk, dv, B, N, H, D, C, rows, eps, stream);
}

// The token-sharded entries (q, k, v, g, dq, dk, dv [B, N, H, D] of this
// process's tokens; kvs and dkvs float32 [B, H, D (D + 1)]). kv: kvs = this
// process's kv and ksum. apply: out from the reduced kvs. bwd_partial: dq and
// this process's d_kv and d_ksum into dkvs, from the reduced kvs and g.
// bwd_finish: dk and dv from the reduced dkvs.
#define LA_SHARDED(SUFFIX, T)                                                                      \
  cudaError_t linear_attention_kv_##SUFFIX(const void* k, const void* v, void* kvs, int B, int N,  \
                                           int H, int D, int C, int rows, void* stream) {         \
    return sharded<Sharded::kKv, T>(k, v, nullptr, kvs, nullptr, B, N, H, D, C, rows, 0.f,        \
                                    stream);                                                       \
  }                                                                                                \
  cudaError_t linear_attention_apply_##SUFFIX(const void* q, const void* kvs, void* out, int B,    \
                                              int N, int H, int D, int C, int rows, float eps,     \
                                              void* stream) {                                      \
    return sharded<Sharded::kApply, T>(q, kvs, nullptr, out, nullptr, B, N, H, D, C, rows, eps,   \
                                       stream);                                                    \
  }                                                                                                \
  cudaError_t linear_attention_bwd_partial_##SUFFIX(const void* q, const void* g, const void* kvs, \
                                                    void* dq, void* dkvs, int B, int N, int H,     \
                                                    int D, int C, int rows, float eps,             \
                                                    void* stream) {                                \
    return sharded<Sharded::kBwdPartial, T>(q, g, kvs, dq, dkvs, B, N, H, D, C, rows, eps,        \
                                            stream);                                               \
  }                                                                                                \
  cudaError_t linear_attention_bwd_finish_##SUFFIX(const void* k, const void* v, const void* dkvs, \
                                                   void* dk, void* dv, int B, int N, int H, int D, \
                                                   int C, int rows, void* stream) {                \
    return sharded<Sharded::kBwdFinish, T>(k, v, dkvs, dk, dv, B, N, H, D, C, rows, 0.f, stream); \
  }

LA_SHARDED(f32, float)
LA_SHARDED(bf16, __nv_bfloat16)
#undef LA_SHARDED

// Dynamic shared memory of one block in bytes (either dtype) for ranks of
// `rows` tokens, or -1.
int linear_attention_smem_bytes(int D, int backward, int rows) {
  switch (D) {
    case 32: {
      const int tr = tile_rows<32>(rows, backward);
      return 4 * (backward ? bwd_smem_floats<32>(tr) : fwd_smem_floats<32>(tr));
    }
    case 64: {
      const int tr = tile_rows<64>(rows, backward);
      return 4 * (backward ? bwd_smem_floats<64>(tr) : fwd_smem_floats<64>(tr));
    }
    case 128: {
      const int tr = tile_rows<128>(rows, backward);
      return 4 * (backward ? bwd_smem_floats<128>(tr) : fwd_smem_floats<128>(tr));
    }
    default: return -1;
  }
}

const char* linear_attention_error_string(cudaError_t err) { return cudaGetErrorString(err); }

}  // extern "C"
