// The int8 post-training-quantization (PTQ) rung's two kernels, for Hopper
// (sm_90a): the dynamic per-tensor activation quantization (K2) and the int8
// convolution with an int32 accumulator and a fused dequantizing epilogue
// (K1).
//
// Neither replaces a Pallas kernel: the JAX package runs its int8 rung
// (esr_tpu/config/quantize.py) through XLA, quantize_symmetric in jnp and
// lax.conv_general_dilated / dot_general on int8 operands with
// preferred_element_type=int32. PyTorch has no int8 convolution on CUDA, so
// the port writes both by hand. Semantics, exactly the reference's:
//   - activations per tensor: scale = max(amax, 1e-12) / 127, q = clip(
//     round_half_even(x / scale), -127, 127), IEEE division (no fast math);
//   - weights per output channel, symmetric (quantized by the plain
//     function on the host side of the seam, once per weight);
//   - acc = sum q_x * q_w in int32 (|acc| <= K * 127^2 < 1728 * 127^2 <
//     2^31 at the flagship), exact, so its order does not matter;
//   - out = float(acc) * (s_x * s_w[n]), then + bias[n]: two roundings in
//     that order, with no FMA contraction (__fmul_rn / __fadd_rn).
// So the kernels are bitwise equal to their plain versions
// (esr_tpu_torch/ops/int8_cuda.py), which the CPU runs.
//
// What bounds them on the card. A flagship window runs 79 seams; 63 of
// them at the 12x20 bottleneck, where M = B*12*20 = 240 (B = 1) or 960
// (lanes 4), N <= 216 and K <= 1728. Their bounds are 0.03-0.4 us (bytes:
// the weights and the output), so a launch's floor (a few us) and the
// latency of a serial chain of loads bound them, never the tensor cores.
// The head and tail seams (M 11520-184320, N <= 16, K <= 288) are bound by
// bytes (the f32 output) and sit near the launch floor; there this design
// is up to 5.5 us a call slower than the previous kernel, which loaded its
// fragments straight from global memory: a block's fixed cost (the k
// table, the ring's barriers) and, at two row tiles a warp, 80 registers
// (6 blocks a streaming multiprocessor: the lanes-4 head seam's 1440
// blocks take two waves) outweigh the staging at 2-5 k-steps.
//
// K1, int8_conv: an implicit GEMM, M rows (output pixels), N out-channels,
// K = kh*kw*Cp (tap-major, the padded channels minor), in k-steps of 32.
//   - A block is 4 warps; each warp owns MT tiles of 16 rows x 8*NT
//     out-channels and runs mma.sync.m16n8k32 (s8 x s8 -> s32). The warps
//     tile the block as WM x WN, so a block is BM = 16*WM*MT rows x BN =
//     8*NT*WN out-channels, from 16 x 64 at the bottleneck to 128 x 8 at
//     the head, where two row tiles a warp halve the blocks (their fixed
//     cost, not their copies, bounds those seams).
//   - Enough blocks in flight at M = 240: the K steps are split across the
//     `split` blocks of a thread-block cluster (2-8 along the grid's z), each
//     taking a contiguous slice. The non-leader blocks leave their int32
//     partial accumulators in their shared memory; the leader (rank 0) adds
//     them through distributed shared memory in rank order and alone runs
//     the epilogue. One launch, no global workspace, nothing to zero.
//   - Operands are staged in shared memory by cp.async in a ring of 4
//     stages (three k-steps in flight while one is multiplied). A is the
//     im2col gather of the int8 NHWC input, 16, 8 or 4 bytes a copy (what
//     divides Cp), zero-filled outside the image and past K; B (the packed
//     weight [Np][Kp]) is copied once per block, 16 bytes a copy. A staged
//     row is 32 k-bytes padded to 48, so the warps' 32-bit fragment loads
//     hit 32 distinct banks.
//   - Address arithmetic is hoisted: each thread's rows (image, first input
//     row and column) are computed once, and the block's slice of K is
//     decoded once into a table of (dy, dx, channel) per copy; the K loop
//     does no integer division.
//   - mma.sync and not wgmma: at the bottleneck a block's tile is 16-64
//     rows, below wgmma's 64-row warpgroup tile, and the work is latency
//     bound; wgmma would cut the blocks in flight by 4 and needs swizzled
//     shared-memory descriptors, for tensor-core rate these seams cannot use.
//   - The tile shape, the split and the copy width come from the launch
//     plan in Python (ops/int8_cuda.py:conv_plan); the entry point refuses a
//     plan it cannot run.
//
// K2, quantize_per_tensor: the amax (NaN propagates, as jnp.max) and then
// the quantization, over items of 4 channels at one pixel: it reads x in
// its NCHW layout (consecutive threads on consecutive pixels of one channel
// quad) and writes q in the layout K1 reads, NHWC with the channels padded
// to a multiple of 4 with zeros, one 32-bit store an item. Bound by bytes
// (4 read, 1 written per element) and, at the flagship's sizes, by the
// latency of its dependent steps (read, reduce, exchange, quantize, write)
// and the launch floor. ONE launch for every size: a cooperative grid of
// 512-thread blocks (all resident at once, up to 4 a streaming
// multiprocessor), each staging its items' channels in shared memory so x
// is read once; the blocks exchange their partial amaxes through a scratch
// array the caller keeps, published by a grid barrier (one block needs
// none). Every partial is written before it is read, so nothing is zeroed
// or reset, and no host synchronization is needed: a CUDA graph can capture
// it. Index arithmetic by multiply-high, not division.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;  // the portable cluster size (K1's split)

// n / d for 0 <= n < 2^31 with no division: the multiply-high method of
// CUTLASS's FastDivmod, m = ceil(2^p / d) with p = 31 + ceil(log2 d), made
// on the host once a launch.
struct FastDiv {
  int d;
  unsigned m, s;
};

inline FastDiv make_fast_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1LL << l) < d) ++l;
    const unsigned p = 31u + (unsigned)l;
    f.m = (unsigned)(((1ULL << p) + (unsigned)d - 1) / (unsigned)d);
    f.s = p - 32u;
  }
  return f;
}

__device__ __forceinline__ int fast_div(int n, const FastDiv& f) {
  return f.d == 1 ? n : (int)(__umulhi((unsigned)n, f.m) >> f.s);
}

// The cluster barrier in two halves (PTX barrier.cluster): arrive early with
// no ordering, wait before the first access to another block's shared
// memory (every block of the cluster has then started); and a full barrier
// whose release / acquire makes the stores before it visible after it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync_release_acquire() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// -- K2 ----------------------------------------------------------------------

constexpr int kQuantThreads = 512;
constexpr int kQuantBlocksPerSm = 4;  // what stays resident at the largest staging
// (pixel, channel quad) items a block stages: 16 bytes each, with the
// block's static 256 bytes within the 48 KB a block has without opting in
constexpr int kQuantItemsMax = 3040;
constexpr int kMaxPartials = 1024;  // blocks of a launch: one amax partial each

__device__ __forceinline__ float max_nan(float a, float v) {
  return (v > a || v != v) ? v : a;  // a NaN, once met, stays (as jnp.max)
}

// The block's max; every thread gets it. `red` holds 32 floats.
__device__ __forceinline__ float block_amax(float a, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) a = max_nan(a, __shfl_xor_sync(0xffffffffu, a, d));
  if (lane == 0) red[warp] = a;
  __syncthreads();
  a = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) a = max_nan(a, __shfl_xor_sync(0xffffffffu, a, d));
  return a;
}

__device__ __forceinline__ float scale_of(float amax) {
  // jnp.maximum(amax, 1e-12) / 127: NaN propagates, as in the reference
  return __fdiv_rn(amax != amax ? amax : fmaxf(amax, 1e-12f), 127.0f);
}

__device__ __forceinline__ int quantize_one(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));  // round half to even
  return (int)fminf(fmaxf(r, -127.f), 127.f);
}

// Item i of the (image, channel quad, pixel) items, i = (b * Cp/4 + quad) *
// HW + pix: where its 4 bytes of q go (item_at) and x's 4 channels at the
// pixel, 0 past C (load_item).
struct Item {
  int dst;  // its 4 bytes of q
  int nc;   // channels of the quad below C (1..4)
};

__device__ __forceinline__ Item item_at(int i, int C, int HW, int Cp, const FastDiv& fd_hw,
                                        const FastDiv& fd_nq) {
  const int bq = fast_div(i, fd_hw);
  const int pix = i - bq * HW;
  const int b = fast_div(bq, fd_nq);
  const int c0 = 4 * (bq - b * (Cp >> 2));
  return {(b * HW + pix) * Cp + c0, min(4, C - c0)};
}

__device__ __forceinline__ float4 load_item(const float* __restrict__ x, int i, int C, int HW,
                                            int Cp, const FastDiv& fd_hw,
                                            const FastDiv& fd_nq) {
  const int bq = fast_div(i, fd_hw);
  const int pix = i - bq * HW;
  const int b = fast_div(bq, fd_nq);
  const int c0 = 4 * (bq - b * (Cp >> 2));
  const float* src = x + ((size_t)b * C + c0) * HW + pix;
  float4 v;
  v.x = __ldg(src);  // c0 < C: Cp is C rounded up to 4
  v.y = c0 + 1 < C ? __ldg(src + HW) : 0.f;
  v.z = c0 + 2 < C ? __ldg(src + 2 * HW) : 0.f;
  v.w = c0 + 3 < C ? __ldg(src + 3 * HW) : 0.f;
  return v;
}

__device__ __forceinline__ float amax4(float a, const float4& v) {
  return max_nan(max_nan(max_nan(max_nan(a, fabsf(v.x)), fabsf(v.y)), fabsf(v.z)),
                 fabsf(v.w));
}

// The 4 bytes of an item: the channels past C stay 0, as in the plain version
// (even under a NaN scale).
__device__ __forceinline__ void store_item(int8_t* __restrict__ q, const Item& it,
                                           const float4& v, float scale) {
  const float c[4] = {v.x, v.y, v.z, v.w};
  unsigned packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < it.nc) packed |= (unsigned)(quantize_one(c[j], scale) & 0xff) << (8 * j);
  }
  *reinterpret_cast<unsigned*>(q + it.dst) = packed;
}

// One launch. Block b takes a contiguous range of the items and reduces the
// amax of their 4 channels; with more than one block, it stores it into
// partials[b], a grid barrier publishes them, and every block reduces them
// (every partial is written before it is read: nothing to zero). Then each
// block quantizes its items. With `stage` (a range that fits the block's
// shared memory) the first pass keeps what it read there (two items in
// flight a thread) and the second reads it back (each thread what it
// wrote); without, each block reads its range of x again in the second pass
// (from L2 where it stayed), so the one launch takes a tensor of any size.
__global__ void __launch_bounds__(kQuantThreads, kQuantBlocksPerSm)
quantize_kernel(const float* __restrict__ x, int B, int C, int HW, int Cp, FastDiv fd_hw,
                FastDiv fd_nq, int stage, float* __restrict__ partials,
                int8_t* __restrict__ q, float* __restrict__ scale_out) {
  extern __shared__ __align__(16) unsigned char qsmem[];
  float4* staged = reinterpret_cast<float4*>(qsmem);
  __shared__ float red[32], red2[32];
  const int nb = (int)gridDim.x;
  const int items = B * (Cp >> 2) * HW;
  const int i0 = (int)((long long)blockIdx.x * items / nb);
  const int i1 = (int)((long long)(blockIdx.x + 1) * items / nb);
  float a = 0.f;
  for (int i = i0 + threadIdx.x; i < i1; i += 2 * kQuantThreads) {
    const int i2 = i + kQuantThreads;
    const float4 v = load_item(x, i, C, HW, Cp, fd_hw, fd_nq);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i2 < i1) w = load_item(x, i2, C, HW, Cp, fd_hw, fd_nq);
    if (stage) {
      staged[i - i0] = v;
      if (i2 < i1) staged[i2 - i0] = w;
    }
    a = amax4(amax4(a, v), w);
  }
  float amax = block_amax(a, red);
  if (nb > 1) {
    if (threadIdx.x == 0) partials[blockIdx.x] = amax;
    cg::this_grid().sync();
    float p = 0.f;
    for (int i = threadIdx.x; i < nb; i += kQuantThreads) p = max_nan(p, __ldcg(partials + i));
    amax = block_amax(p, red2);
  }
  const float scale = scale_of(amax);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[0] = scale;
  if (stage) {
    for (int i = i0 + threadIdx.x; i < i1; i += kQuantThreads) {
      store_item(q, item_at(i, C, HW, Cp, fd_hw, fd_nq), staged[i - i0], scale);
    }
    return;
  }
  for (int i = i0 + threadIdx.x; i < i1; i += 2 * kQuantThreads) {
    const int i2 = i + kQuantThreads;
    const float4 v = load_item(x, i, C, HW, Cp, fd_hw, fd_nq);
    if (i2 < i1) {
      const float4 w = load_item(x, i2, C, HW, Cp, fd_hw, fd_nq);
      store_item(q, item_at(i2, C, HW, Cp, fd_hw, fd_nq), w, scale);
    }
    store_item(q, item_at(i, C, HW, Cp, fd_hw, fd_nq), v, scale);
  }
}

// -- K1 ----------------------------------------------------------------------

constexpr int kConvThreads = 128;  // 4 warps
constexpr int kStages = 4;         // the cp.async ring
constexpr int kKStep = 32;         // one mma.m16n8k32
constexpr int kRowBytes = 48;      // a staged row: 32 k-bytes + 16 of padding
constexpr int kMaxKChunks = 1024;  // the decoded k table of a block's slice
constexpr int kMaxSplit = kMaxCluster;
constexpr int kMaxBN = 128;  // the widest block's out-channels
// the dynamic shared memory a block may use: 48 KB (no opt-in) less the
// static epilogue operands
constexpr int kMaxSmem = 48 * 1024 - 2 * kMaxBN * 4;

struct ConvGeom {
  int B, H, W, Cp, Ho, Wo, N, Np, Kp, kh, kw, stride, pad, dil;
  int split;  // blocks along K (the cluster's size)
  int chunk;  // bytes of one A copy: 4, 8 or 16
  int slice_chunks;  // entries of the largest slice's k table
  FastDiv npix, wo;  // / (Ho * Wo), / Wo
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A copy of `bytes` (4, 8 or 16) into shared memory, zero-filled when !ok.
__device__ __forceinline__ void cp_async(unsigned dst, const void* src, int bytes, bool ok) {
  const int n = ok ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(n)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int conv_bm(int wm, int mt) { return 16 * wm * mt; }
__host__ __device__ constexpr int conv_bn(int wn, int nt) { return 8 * nt * wn; }

// Dynamic shared memory: the ring of stages (BM A rows, then BN B rows,
// kRowBytes each), the k table of the block's slice (one int a copy, padded
// to 16 bytes), and with a split the leader's slots for the other blocks'
// int32 partials (split - 1 of MT * NT * 4 per thread).
__host__ __device__ inline int conv_table_offset(int bm, int bn) {
  return kStages * (bm + bn) * kRowBytes;
}

__host__ __device__ inline int conv_slots_offset(int bm, int bn, int slice_chunks) {
  return conv_table_offset(bm, bn) + (4 * slice_chunks + 15) / 16 * 16;
}

__host__ __device__ inline int conv_smem_bytes(int bm, int bn, int mt, int nt, int split,
                                               int slice_chunks) {
  return conv_slots_offset(bm, bn, slice_chunks) +
         (split - 1) * mt * nt * 4 * kConvThreads * 4;
}

// Fragments (PTX ISA, mma.m16n8k32 .s8): lane = 4 * g + t. A: reg 0 row g,
// k 4t..4t+3; reg 1 row g + 8, the same k; regs 2 and 3 the same rows at
// k + 16. B: reg 0 k 4t..4t+3 of column g, reg 1 k + 16. C: regs 0, 1 row
// g, columns 2t, 2t + 1; regs 2, 3 row g + 8.
template <int WM, int WN, int NT, int MT>
__global__ void __launch_bounds__(kConvThreads)
int8_igemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  const float* __restrict__ bias, float* __restrict__ out, ConvGeom G) {
  constexpr int BM = conv_bm(WM, MT);
  constexpr int BN = conv_bn(WN, NT);
  constexpr int STAGE = (BM + BN) * kRowBytes;
  constexpr int MAXA = (BM * (kKStep / 4) + kConvThreads - 1) / kConvThreads;
  constexpr int MAXB = (BN * 2 + kConvThreads - 1) / kConvThreads;
  static_assert(BN <= kMaxBN, "the epilogue operands are staged for kMaxBN out-channels");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int npix = G.Ho * G.Wo;
  const int M = G.B * npix;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  if (G.split > 1) cluster_arrive_relaxed();
  // the epilogue's operands, staged now so their latency hides under the K
  // loop (the k table's barrier below publishes them)
  __shared__ float s_w[kMaxBN], b_n[kMaxBN];
  const float s_x = __ldg(sx);
  for (int i = tid; i < BN; i += kConvThreads) {
    const int n = n0 + i;
    s_w[i] = n < G.N ? __ldg(sw + n) : 0.f;
    b_n[i] = n < G.N && bias != nullptr ? __ldg(bias + n) : 0.f;
  }

  // the block's slice of the k-steps (every block gets at least one)
  const int ks = G.Kp / kKStep;
  const int z = G.split > 1 ? (int)blockIdx.z : 0;
  const int kbeg = (int)((long long)z * ks / G.split);
  const int nsteps = (int)((long long)(z + 1) * ks / G.split) - kbeg;

  // the slice decoded once: copy j (bytes k = 32 * kbeg + j * chunk) is
  // (dy << 24 | dx << 16 | channel), or -1 past the kh*kw taps
  const int cpr = kKStep / G.chunk;  // A copies a staged row
  int* ktab = reinterpret_cast<int*>(smem + conv_table_offset(BM, BN));
  const int taps = G.kh * G.kw;
  for (int j = tid; j < nsteps * cpr; j += kConvThreads) {
    const int k = kbeg * kKStep + j * G.chunk;
    const int tap = k / G.Cp;
    const int c = k - tap * G.Cp;
    const int ky = tap / G.kw;
    ktab[j] = tap < taps ? ((ky * G.dil) << 24) | (((tap - ky * G.kw) * G.dil) << 16) | c : -1;
  }

  // this thread's A copies (row, copy in the row), their rows decoded once
  int a_dst[MAXA], a_sub[MAXA], a_base[MAXA], a_iy[MAXA], a_ix[MAXA];
  bool a_on[MAXA], a_row[MAXA];
#pragma unroll
  for (int i = 0; i < MAXA; ++i) {
    const int idx = tid + i * kConvThreads;
    a_on[i] = idx < BM * cpr;
    const int row = idx / cpr;
    const int sub = idx - row * cpr;
    const int m = m0 + row;
    a_row[i] = a_on[i] && m < M;
    const int mm = a_row[i] ? m : 0;
    const int b = fast_div(mm, G.npix);
    const int r = mm - b * npix;
    const int oy = fast_div(r, G.wo);
    a_dst[i] = row * kRowBytes + sub * G.chunk;
    a_sub[i] = sub;
    a_base[i] = b * G.H * G.W;
    a_iy[i] = oy * G.stride - G.pad;
    a_ix[i] = (r - oy * G.Wo) * G.stride - G.pad;
  }
  // this thread's B copies (out-channel row, half of the k-step)
  int b_dst[MAXB];
  const int8_t* b_src[MAXB];
  bool b_on[MAXB], b_ok[MAXB];
#pragma unroll
  for (int i = 0; i < MAXB; ++i) {
    const int idx = tid + i * kConvThreads;
    b_on[i] = idx < BN * 2;
    const int n = n0 + (idx >> 1);
    b_ok[i] = b_on[i] && n < G.Np;
    b_dst[i] = BM * kRowBytes + (idx >> 1) * kRowBytes + (idx & 1) * 16;
    b_src[i] = wq + (b_ok[i] ? (size_t)n * G.Kp + (idx & 1) * 16 : 0);
  }
  __syncthreads();  // the k table

  const unsigned stage0 = smem_addr(smem);
  auto load = [&](int buf, int ls) {
    const unsigned base = stage0 + buf * STAGE;
#pragma unroll
    for (int i = 0; i < MAXA; ++i) {
      if (!a_on[i]) continue;
      const int e = ktab[ls * cpr + a_sub[i]];
      const int8_t* src = xq;
      bool ok = a_row[i] && e >= 0;
      if (ok) {
        const int iy = a_iy[i] + (e >> 24);
        const int ix = a_ix[i] + ((e >> 16) & 0xff);
        ok = iy >= 0 && iy < G.H && ix >= 0 && ix < G.W;
        if (ok) src = xq + (size_t)(a_base[i] + iy * G.W + ix) * G.Cp + (e & 0xffff);
      }
      cp_async(base + a_dst[i], src, G.chunk, ok);
    }
    const int koff = (kbeg + ls) * kKStep;
#pragma unroll
    for (int i = 0; i < MAXB; ++i) {
      if (b_on[i]) cp_async(base + b_dst[i], b_ok[i] ? b_src[i] + koff : wq, 16, b_ok[i]);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  // the warp's row tiles are wm * MT .. wm * MT + MT - 1 of the block's
  const int a_row0 = (wm * MT * 16 + g) * kRowBytes + 4 * t;
  const int b_row0 = BM * kRowBytes + (wn * 8 * NT + g) * kRowBytes + 4 * t;
  for (int ls = 0; ls < nsteps; ++ls) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step ls landed; every warp is done with step ls - 1
    const int next = ls + kStages - 1;
    if (next < nsteps) load(next % kStages, next);
    cp_async_commit();
    const unsigned char* st = smem + (ls % kStages) * STAGE;
    unsigned a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const unsigned char* ar = st + a_row0 + mt * 16 * kRowBytes;
      a[mt][0] = *reinterpret_cast<const unsigned*>(ar);
      a[mt][1] = *reinterpret_cast<const unsigned*>(ar + 8 * kRowBytes);
      a[mt][2] = *reinterpret_cast<const unsigned*>(ar + 16);
      a[mt][3] = *reinterpret_cast<const unsigned*>(ar + 8 * kRowBytes + 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const unsigned char* br = st + b_row0 + 8 * j * kRowBytes;
      const unsigned b0 = *reinterpret_cast<const unsigned*>(br);
      const unsigned b1 = *reinterpret_cast<const unsigned*>(br + 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][j], a[mt], b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  if (G.split > 1) {
    // the K split's int32 partials: each non-leader block stores its own
    // into its slot of the leader's shared memory (a push through
    // distributed shared memory: nothing waits on a remote load); after the
    // barrier the leader adds the slots in rank order (exact: integer sums)
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    int* slots = reinterpret_cast<int*>(smem + conv_slots_offset(BM, BN, G.slice_chunks));
    constexpr int SLOT = MT * NT * 4 * kConvThreads;
    cluster_wait();  // every block of the cluster has started
    if (rank != 0) {
      int* dst = cluster.map_shared_rank(slots, 0) + (rank - 1) * SLOT;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dst[((mt * NT + j) * 4 + e) * kConvThreads + tid] = acc[mt][j][e];
          }
        }
      }
    }
    cluster_sync_release_acquire();
    if (rank != 0) return;
    for (int r = 0; r < G.split - 1; ++r) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][j][e] += slots[r * SLOT + ((mt * NT + j) * 4 + e) * kConvThreads + tid];
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (wm * MT + mt) * 16 + g + 8 * h;
      if (m >= M) continue;
      const int b = fast_div(m, G.npix);
      float* orow = out + (size_t)b * G.N * npix + (m - b * npix);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 8 * NT + 8 * j + 2 * t + e;
          if (n >= G.N) continue;
          float v = __fmul_rn(__int2float_rn(acc[mt][j][2 * h + e]), __fmul_rn(s_x, s_w[n - n0]));
          if (bias != nullptr) v = __fadd_rn(v, b_n[n - n0]);
          orow[(size_t)n * npix] = v;
        }
      }
    }
  }
}

template <int WM, int WN, int NT, int MT>
int launch_conv(const int8_t* xq, const int8_t* wq, const float* sx, const float* sw,
                const float* bias, float* out, const ConvGeom& G, int smem,
                cudaStream_t st) {
  const int M = G.B * G.Ho * G.Wo;
  constexpr int BM = conv_bm(WM, MT);
  constexpr int BN = conv_bn(WN, NT);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + BM - 1) / BM, (G.N + BN - 1) / BN, G.split);
  cfg.blockDim = dim3(kConvThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = G.split;
  cfg.attrs = attr;
  cfg.numAttrs = G.split > 1 ? 1 : 0;  // no split: a plain grid, no cluster to schedule
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_igemm_kernel<WM, WN, NT, MT>, xq, wq,
                                             sx, sw, bias, out, G);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// Plain C entry points (loaded with ctypes); each returns cudaGetLastError()
// after its launches: 0 on success, cudaErrorInvalidValue for arguments the
// kernels do not take. The caller allocates every output.

// x NCHW [B, C, H*W] f32 (contiguous) -> q NHWC [B, H*W, Cp] int8 and
// scale [1] f32, in one cooperative launch of `blocks` blocks (1..1024, all
// resident at once) of 512 threads, each taking its share of the B * Cp/4 *
// H*W items: staged in shared memory when the share is at most 3040 items,
// else read twice from x. Through partials [blocks] f32, which the caller
// keeps (it needs no initial value).
extern "C" int quantize_per_tensor_f32(const float* x, int B, int C, int HW, int Cp,
                                       int8_t* q, float* scale, float* partials, int blocks,
                                       void* stream) {
  if (B < 1 || C < 1 || HW < 1 || Cp < C || Cp % 4 != 0 || Cp - C >= 4 ||
      (long long)B * HW * Cp >= (1LL << 31) || (long long)B * C * HW >= (1LL << 31) ||
      blocks < 1 || blocks > kMaxPartials || partials == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int items = B * (Cp / 4) * HW;
  const int per = (items + blocks - 1) / blocks;
  const int stage = per <= kQuantItemsMax;
  // the most blocks resident at once (at the largest staging), once per device
  static int resident[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
  if (resident[device] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantize_kernel, kQuantThreads,
                                                        kQuantItemsMax * (int)sizeof(float4));
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    resident[device] = per_sm * sms;
  }
  if (blocks > resident[device]) return (int)cudaErrorCooperativeLaunchTooLarge;
  const FastDiv fd_hw = make_fast_div(HW), fd_nq = make_fast_div(Cp / 4);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kQuantThreads, 1, 1);
  cfg.dynamicSmemBytes = stage ? (size_t)per * sizeof(float4) : 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, quantize_kernel, x, B, C, HW, Cp, fd_hw, fd_nq, stage,
                           partials, q, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// xq NHWC [B, H, W, Cp] int8, wq [Np][Kp] int8 (row n: k = tap * Cp + c,
// zero-padded; rows N..Np zero), sx [1], sw [N], bias [N] or null ->
// out NCHW [B, N, Ho, Wo] f32. The plan: (wm, wn, nt, mt) one of the tile
// shapes below (a block of 16*wm*mt rows x 8*nt*wn out-channels, a warp
// owning mt tiles of 16 rows), split blocks along K (1..8, at most Kp / 32:
// the cluster's size), chunk the bytes of an A copy (4, 8 or 16, dividing
// Cp). Np a multiple of 8, Kp of 32, Kp >= kh * kw * Cp; xq and wq 16-byte
// aligned.
extern "C" int int8_conv_f32(const int8_t* xq, const int8_t* wq, const float* sx,
                             const float* sw, const float* bias, float* out, int B,
                             int H, int W, int Cp, int Ho, int Wo, int N, int Np,
                             int Kp, int kh, int kw, int stride, int pad, int dil, int wm,
                             int wn, int nt, int mt, int split, int chunk, void* stream) {
  const int ks = Kp / kKStep;
  const int slice_chunks = split > 0 && chunk > 0 ? (ks + split - 1) / split * (kKStep / chunk)
                                                  : 0;
  if (B < 1 || H < 1 || W < 1 || Ho < 1 || Wo < 1 || N < 1 || Cp < 4 || Cp % 4 != 0 ||
      Cp >= (1 << 16) || kh < 1 || kw < 1 || stride < 1 || pad < 0 || dil < 1 ||
      (kh - 1) * dil >= 128 || (kw - 1) * dil >= 128 || Kp % kKStep != 0 || Kp < kKStep ||
      Kp < kh * kw * Cp || Np % 8 != 0 || Np < N || split < 1 || split > kMaxSplit ||
      split > ks || (chunk != 4 && chunk != 8 && chunk != 16) || Cp % chunk != 0 ||
      slice_chunks > kMaxKChunks || (reinterpret_cast<uintptr_t>(xq) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(wq) & 15) != 0 || (mt != 1 && mt != 2) ||
      (long long)B * Ho * Wo >= (1LL << 31) || (long long)B * N * Ho * Wo >= (1LL << 31) ||
      (long long)B * H * W * Cp >= (1LL << 31) || (long long)Np * Kp >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = conv_smem_bytes(16 * wm * mt, 8 * nt * wn, mt, nt, split, slice_chunks);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const ConvGeom G{B, H, W, Cp, Ho, Wo, N, Np, Kp, kh, kw, stride, pad, dil, split, chunk,
                   slice_chunks, make_fast_div(Ho * Wo), make_fast_div(Wo)};
  cudaStream_t st = (cudaStream_t)stream;
#define ESR_INT8_TILE(WM_, WN_, NT_, MT_)                                              \
  if (wm == WM_ && wn == WN_ && nt == NT_ && mt == MT_)                                \
    return launch_conv<WM_, WN_, NT_, MT_>(xq, wq, sx, sw, bias, out, G, smem, st);
  ESR_INT8_TILE(4, 1, 1, 1)
  ESR_INT8_TILE(4, 1, 2, 1)
  ESR_INT8_TILE(4, 1, 4, 1)
  ESR_INT8_TILE(1, 4, 2, 1)
  ESR_INT8_TILE(2, 2, 4, 1)
  ESR_INT8_TILE(1, 4, 4, 1)
  ESR_INT8_TILE(4, 1, 1, 2)
  ESR_INT8_TILE(4, 1, 2, 2)
  ESR_INT8_TILE(4, 1, 4, 2)
#undef ESR_INT8_TILE
  return (int)cudaErrorInvalidValue;
}

// One launch of an empty kernel: the launch floor the int8 kernels' times
// are read against.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
