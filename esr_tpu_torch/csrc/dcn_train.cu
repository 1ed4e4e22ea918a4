// Modulated deformable convolution (DCNv2), the train direction, f32, for
// Hopper (sm_90a): the forward that autograd saves for, and its backward.
//
// Replaces two TPU kernels of esr_tpu/ops/dcn_pallas.py:
//   - _dcn_kernel (tile body _dcn_tile_acc), the forward of the op
//     deform_conv2d_pallas, which recasts the bilinear gather as a 4-corner
//     one-hot matrix S[hw, o] on the MXU, and its masked twin
//     _dcn_kernel_masked;
//   - _dcn_bwd_kernel, its fused backward (custom_vjp _bwd), which rebuilds
//     S and gets gx = col2im(W^T g), gW = sum_o cols g^T and the per-corner
//     weight cotangents from transposed MXU products.
// Threads here gather directly: the one-hot products exist only because a
// per-lane scalar gather does not map to the TPU's vector units.
//
// Layouts, the bilinear sampling and the forward body are in dcn_common.cuh.
//
// Three entry points (four with the masked forward):
//   1. dcn_train_fwd_f32 launches the forward body dcn_forward_kernel of
//      dcn_common.cuh, the same code as dcn_fwd.cu's entry: the two
//      directions compute the same output and differ only in who launches
//      them and in their launch counts. Nothing is saved for the backward,
//      which recomputes the sampling (corner indices and weights are ~18 MB
//      per B=32 call, and 14 calls per train step would hold ~250 MB for a
//      few ALU ops each). dcn_train_fwd_masked_f32 launches the same body
//      predicated on activity (replaces _dcn_kernel_masked); the backward
//      stays dense, as in the reference: gx of a zero block is not zero.
//   2. dcn_bwd_pixel_kernel: gx, goffsets and gmask. gcols = g . W[:, group]^T
//      per (row, group, tap), scattered as m * w_corner * gcols into gx (the
//      learned offsets make the col2im irregular), and, fused, the VJP
//      through the corner weights that _corner_pairs/jax.vjp does in the
//      reference: gmask = sum_corner w_corner <x[corner], gcols>, and
//      d/d(dy, dx) of the bilinear weights times m <x[corner], gcols> for
//      goffsets (zero outside the image).
//   3. dcn_wgrad_kernel: gW[k, g*Cg + c, o] = sum_r cols_g[r, k*Cg + c]
//      g[r, o], cols the mask times the bilinear sample. Grid (row chunks,
//      column tiles x out-channel tiles, groups): a block owns tj of its
//      group's K*Cg columns x up to 128 out-channels, so any width runs,
//      and writes one partial per chunk of rows; the wrapper sums the
//      partials in a fixed order (the second pass of the reduction over
//      B*Ho*Wo rows that the TPU kernel carries across its sequential
//      grid). See "What bounds the weight gradient" below.
// All accumulation is f32 FMAs (no TF32).
//
// What bounds the per-pixel backward on the H100, and its design. At the
// flagship training call (x [32,12,20,64], dg 8, K 9, Cout 64, 7680 rows)
// gcols is a contraction of 2*7680*576*64 = 566 MFLOP, 8.5 us at 67 TFLOP/s;
// the bytes are ~12 MB, 3.6 us at 3.35 TB/s: bound by operations. The
// earlier kernel (one thread per (row, group, tap)) scattered gx with 4
// corners x Cg scalar global atomicAdds per item, 17.7M atomics onto 0.49M
// elements with 32 lanes on 32 pixels 256 B apart, and spent one shared and
// Cg global loads per Cg FMAs on gcols. Ownership replaces the global
// atomics here:
//   - One block per (image, group). It holds the image's x slice and a gx
//     accumulator for the group in shared memory (H*W*Cg floats, and three
//     32-bit words an element for gx's fixed point; rows padded to Cg + 1
//     so neighbouring pixels hit different banks), stages
//     W[:, group] once as W^T [tap][o][c], and streams the image's cotangent
//     rows through shared memory in double-buffered cp.async tiles.
//   - gcols is register-blocked: a thread holds 2 rows (1 at Cg > 8, for
//     registers) x one tap x all Cg channels, so per 4 out-channels it
//     loads 2 float4 of g and Cg float4 of W (broadcast) for 8*Cg FMAs, and
//     the scatter comes straight from registers: shared-memory integer
//     reductions into the gx slice (see "Determinism"), x corners read from
//     the x slice.
//   - At the end the block writes its gx slice with plain stores: every
//     element of gx has exactly one writer.
//   - An image whose slices do not fit shared memory, or takes 65536 or
//     more (row, tap) terms a pixel, takes the other instantiation (kOwn =
//     false): blocks of rows, x read from global, and gx scattered to
//     64-bit fixed-point accumulators in global memory, which the entry
//     point zeroes and converts to gx afterwards. When W^T of all taps does
//     not fit, the taps run in passes (kt per pass), the cotangent streamed
//     once per pass. The chooser in ops/dcn_cuda.py picks from the shape.
//   - Groups of more than 32 channels, and a tap of W^T too wide for the
//     staging above, take dcn_bwd_pixel_wide_kernel: channel chunks of 32,
//     W^T and the cotangent staged in pieces of out-channels, gx to global.
//
// What bounds the weight gradient on the H100, and its design. At the
// flagship training call the work is the forward's, 610 MFLOP with the
// gather (9.1 us at 67 TFLOP/s), against ~11 MB (3.2 us at 3.35 TB/s):
// bound by operations.
// The earlier kernel kept scattered single outputs per thread (32 in
// registers, so K*Cg*Cout <= 8192 and basech >= 12 was refused), spent
// two scalar shared loads per FMA, and rebuilt its columns one channel at
// a time between two barriers: 0.161 ms at B=32. Here:
//   - Register micro-tiles: a thread holds 4 columns x 8 out-channels (x 4
//     at <= 32 out-channels). cols is stored [row][column], so per row a
//     thread loads one float4 of its columns and two of the cotangent for
//     32 FMAs; a thread's two quads of the cotangent lie to / 2 apart, so
//     each load of a warp is contiguous.
//   - The gather in the forward's pipeline: each thread owns two items of
//     4 channels of one tap per stage (2 * to / mo rows), their offsets and
//     mask loaded two stages ahead, their corners (float4) one stage ahead
//     and issued before the current stage's FMAs, combined and stored after
//     them; the cotangent rows by cp.async. Two buffers, one barrier a
//     stage. The sampling is computed per (row, tap, 4 channels), as in the
//     forward.
//   - Deterministic split-K: each output of a chunk is one FMA chain over
//     the chunk's rows in order, and the partials are summed in a fixed
//     order, so gW is the same bits from run to run.
//   - The launch configuration comes from ops/dcn_cuda.py:wgrad_config.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): the entry
// point at B=32 0.046 ms (the earlier kernel 0.161 in the same run), B=1
// 0.013-0.019, basech 16 (Cg 16, Cout 128) 0.106, basech 32 (Cg 32,
// Cout 256) 0.446. At B=32 it takes 0.026 ms without its FMAs and 0.031
// without its gather: the two overlap in part.
//
// Determinism: every output is the same bits from run to run. The forward,
// goffsets, gmask and gW have a fixed summation order (goffsets and gmask
// keep the per-element operation order of the earlier kernel). gx is a
// scatter, so its contributions meet in an order that changes between runs;
// they are summed as 64-bit fixed-point integers, whose addition does not
// depend on order:
//   - a first kernel (dcn_bwd_bound_kernel) bounds every contribution: the
//     largest |g|, |mask| and, over (tap, channel), sum_o |W| give
//     |m * w_corner * gcols| <= gmax * mmax * wmax, and a pixel of gx takes
//     at most one corner of each of its image's Ho*Wo*K (row, tap) pairs.
//     The bound words are the maxima's bits, reduced with integer atomicMax
//     (a maximum is order-free; NaN sorts above every number and poisons gx);
//   - each contribution v becomes llrint(v * 2^s), s = 62 - ceil(log2(bound
//     * Ho*Wo*K)), so no sum can overflow, and is added with integer atomics:
//     global 64-bit ones, or on the ownership path three native 32-bit
//     shared ones (shared_add_fix: two unsigned 16-bit parts and the signed
//     high word, none of whose sums can wrap while Ho*Wo*K < 65536, which
//     the chooser makes a condition of that path);
//   - gx = float(sum) * 2^-s, one rounding. Each contribution is off by at
//     most 2^-(s+1), a 2^-63 share of the bound per term: gx is as exact as
//     f32 allows, and the ownership, global and wide paths give the same bits.
// Cost (chip_smoke.py, PERF.md): a bound pass reading g, mask and W once
// (~2.4 MB at the flagship B=32), 12 bytes of shared memory an element of
// the ownership path's gx slice, and off it 8 bytes of global scratch an
// element of gx, zeroed, then converted.

#include "dcn_common.cuh"

#include <algorithm>

namespace {

// The per-pixel backward's launch configuration: chunk_rows rows per block
// (one image when own), tp cotangent rows per shared tile, kt taps per
// pass, own = the x / gx slices live in shared memory.
struct BwdTile {
  int chunk_rows, tp, kt, own;
};

// The ownership path's gx slice: H*W rows of Cg + 1 accumulators of three
// 32-bit words (shared_add_fix), in 32-bit words rounded up to a multiple of
// 4, so the float regions after it stay 16-byte aligned.
__host__ __device__ int fix_slice_words(int hw, int lds) {
  return (3 * hw * lds + 3) & ~3;
}

// Mirrored by bwd_smem_bytes in ops/dcn_cuda.py.
size_t bwd_smem_bytes(const Geom& G, const BwdTile& T) {
  const size_t cg = G.Cin / G.dg;
  const size_t cgp = (cg + 3) / 4 * 4;
  const size_t coutp = ((size_t)G.Cout + 3) / 4 * 4;
  const size_t nbuf = (T.chunk_rows + T.tp - 1) / T.tp > 1 ? 2 : 1;
  size_t f = (size_t)T.kt * coutp * cgp + nbuf * T.tp * (coutp + 4);
  if (T.own) f += (size_t)G.H * G.W * (cg + 1) + fix_slice_words(G.H * G.W, cg + 1);
  return f * sizeof(float);
}

// -- gx in 64-bit fixed point (see "Determinism" above) --------------------

// The bound words: the bits of max|g|, max|mask| and max over (tap, channel)
// of sum_o |W[k, c, o]|, each a non-negative float (or NaN), so unsigned
// order is float order and NaN (0x7fc00000 after fabsf) tops +inf.
constexpr int kBoundWords = 3;

__device__ __forceinline__ float max_nan(float a, float v) {
  return (v > a || v != v) ? v : a;  // a NaN, once met, stays
}

__device__ __forceinline__ float block_max_nan(float v, float* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, d));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) v = max_nan(v, red[i]);
  return v;
}

__global__ void __launch_bounds__(kThreads)
dcn_bwd_bound_kernel(const float* __restrict__ gout, long long ng,
                     const float* __restrict__ mask, long long nm,
                     const float* __restrict__ w, int kcin, int Cout,
                     unsigned* __restrict__ words) {
  __shared__ float red[kThreads / 32];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float a = 0.f, b = 0.f, c = 0.f;
  for (long long i = t0; i < ng; i += stride) a = max_nan(a, fabsf(gout[i]));
  for (long long i = t0; i < nm; i += stride) b = max_nan(b, fabsf(mask[i]));
  for (long long i = t0; i < kcin; i += stride) {
    float sum = 0.f;
    for (int o = 0; o < Cout; ++o) sum += fabsf(w[i * Cout + o]);
    c = max_nan(c, sum);
  }
  a = block_max_nan(a, red);
  b = block_max_nan(b, red);
  c = block_max_nan(c, red);
  if (threadIdx.x == 0) {
    atomicMax(words + 0, __float_as_uint(a));
    atomicMax(words + 1, __float_as_uint(b));
    atomicMax(words + 2, __float_as_uint(c));
  }
}

// The fixed-point scale 2^s and its inverse from the bound words: a sum at
// one pixel takes at most npk terms of at most gmax * mmax * wmax, and
// 2^62 / 2^s exceeds that. A non-finite bound gives inv = NaN: gx is NaN.
// The words are read anew at each call (volatile), so a kernel that needs
// the scale in two places holds no register for it in between.
struct FixScale {
  float s, inv;
};

__device__ __forceinline__ FixScale fix_scale(const volatile unsigned* words, int npk) {
  const double bound = (double)__uint_as_float(words[0]) *
                       (double)__uint_as_float(words[1]) *
                       (double)__uint_as_float(words[2]) * (double)npk;
  if (!isfinite(bound)) return FixScale{0.f, __int_as_float(0x7fc00000)};
  // bound < 2^e, e from the biased exponent (0 for 0 and subnormals: s is
  // then clamped); powers of two are built from their bits
  const int e = (int)((__double_as_longlong(bound) >> 52) & 0x7ff) - 1022;
  const int s = max(-126, min(126, 62 - e));
  return FixScale{__int_as_float((127 + s) << 23), __int_as_float((127 - s) << 23)};
}

__device__ __forceinline__ unsigned long long to_fix(float v, const FixScale& f) {
  return (unsigned long long)__float2ll_rn(v * f.s);
}

__device__ __forceinline__ float from_fix(long long acc, const FixScale& f) {
  return __ll2float_rn(acc) * f.inv;
}

// A 64-bit fixed-point accumulator in shared memory as three 32-bit words,
// added with native 32-bit reductions that return nothing: the value's low
// 32 bits as two unsigned 16-bit parts, and its signed high word. A sum of
// n < 65536 parts below 2^16 stays below 2^32, and the high words' sum is
// the total's (below 2^62) over 2^32 plus at most n, so no word wraps and
// the three sums give the total exactly, in any order. (64-bit shared
// atomics, and a pair of 32-bit ones passing the carry on, both made ptxas
// spill registers here.)
__device__ __forceinline__ void shared_add_fix(unsigned* acc, unsigned long long v) {
  atomicAdd(acc, (unsigned)v & 0xffffu);
  atomicAdd(acc + 1, ((unsigned)v) >> 16);
  atomicAdd(acc + 2, (unsigned)(v >> 32));
}

__device__ __forceinline__ long long shared_fix_total(const unsigned* acc) {
  return ((long long)(int)acc[2] << 32) + ((long long)acc[1] << 16) + (long long)acc[0];
}

// gx = the global accumulators back in float (the global and wide paths).
__global__ void __launch_bounds__(kThreads)
dcn_bwd_fix_to_float_kernel(const long long* __restrict__ fix, long long n,
                            const unsigned* __restrict__ words, int npk,
                            float* __restrict__ gx) {
  const FixScale f = fix_scale(words, npk);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    gx[i] = from_fix(fix[i], f);
  }
}

// MAXCG bounds the per-thread gcols registers; the caller picks the
// smallest instantiation with Cg <= MAXCG.
template <int MAXCG, bool kOwn>
__global__ void __launch_bounds__(kThreads)
dcn_bwd_pixel_kernel(const float* __restrict__ x, const float* __restrict__ off,
                     const float* __restrict__ mask,
                     const float* __restrict__ w,
                     const float* __restrict__ gout, float* __restrict__ gx,
                     float* __restrict__ goff, float* __restrict__ gmask,
                     long long* __restrict__ fix,
                     const unsigned* __restrict__ words, Geom G, BwdTile T) {
  extern __shared__ __align__(16) float smem[];
  const int K = G.kh * G.kw;
  const int cg = G.Cin / G.dg;
  const int cgp = (cg + 3) & ~3;
  const int coutp = (G.Cout + 3) & ~3;
  const int ldg = coutp + 4;  // 8 lanes' LDS.128 on 8 rows hit distinct banks
  const int lds = cg + 1;
  const int hw = G.H * G.W;
  const int npix = G.Ho * G.Wo;
  const int rows = G.B * npix;
  const int g = blockIdx.y;
  const int start = blockIdx.x * T.chunk_rows;
  const int end = min(rows, start + T.chunk_rows);
  const int tp = T.tp;
  // rows per item: 2 share each W^T load; 1 keeps Cg 32's registers unspilled
  constexpr int kRP = MAXCG <= 8 ? 2 : 1;
  const int stride_p = tp / kRP;
  const int nbuf = (T.chunk_rows + tp - 1) / tp > 1 ? 2 : 1;
  // kOwn: the gx slice as 64-bit accumulators [hw][lds] first, 16-byte
  // aligned, then the float regions
  unsigned* gxs = reinterpret_cast<unsigned*>(smem);       // [hw][lds][3]
  float* wt = smem + (kOwn ? fix_slice_words(hw, lds) : 0);  // [kt][coutp][cgp]
  float* gs = wt + T.kt * coutp * cgp;     // [nbuf][tp][ldg]
  float* xs = gs + nbuf * tp * ldg;        // [hw][lds]   (kOwn)
  const bool vec_g = G.Cout % 4 == 0 && aligned16(gout);
  // the image's channels of this group (kOwn: the block's rows are one
  // image), made where used from the block index read anew (asm volatile),
  // so no register holds it across the loops
  auto image_base = [&]() {
    unsigned bx, by;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
    asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(by));
    return (size_t)((int)bx * T.chunk_rows / npix) * hw * G.Cin + (int)by * cg;
  };

  if constexpr (kOwn) {
    const size_t img = image_base();
    for (int e = threadIdx.x; e < hw * cg; e += blockDim.x) {
      const int pix = e / cg;
      const int c = e - pix * cg;
      xs[pix * lds + c] = x[img + (size_t)pix * G.Cin + c];
      gxs[3 * (pix * lds + c)] = 0;
      gxs[3 * (pix * lds + c) + 1] = 0;
      gxs[3 * (pix * lds + c) + 2] = 0;
    }
  }

  // cotangent rows t*tp .. of the chunk into buffer t & 1, zero past the end
  auto stage_g = [&](int t) {
    float* dst0 = gs + (t & 1) * tp * ldg;
    const int t0 = start + t * tp;
    const int nv = coutp / 4;
    for (int e = threadIdx.x; e < tp * nv; e += blockDim.x) {
      const int p = e / nv;
      const int o = (e - p * nv) * 4;
      const int r = t0 + p;
      float* dst = dst0 + p * ldg + o;
      const float* src = gout + (size_t)r * G.Cout + o;
      if (r < end && vec_g) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (r < end && o + i < G.Cout) {
            cp_async4(dst + i, src + i);
          } else {
            dst[i] = 0.f;
          }
        }
      }
    }
  };

  const int n_tiles = (end - start + tp - 1) / tp;
  for (int k0 = 0; k0 < K; k0 += T.kt) {
    const int nk = min(T.kt, K - k0);
    // W^T of this pass's taps: wt[kk][o][c] = W[k0 + kk, g*Cg + c, o], zero-padded
    for (int e = threadIdx.x; e < nk * cgp * coutp; e += blockDim.x) {
      const int o = e % coutp;
      const int t = e / coutp;
      const int c = t % cgp;
      const int kk = t / cgp;
      wt[(kk * coutp + o) * cgp + c] =
          (o < G.Cout && c < cg)
              ? __ldg(w + ((size_t)(k0 + kk) * G.Cin + g * cg + c) * G.Cout + o)
              : 0.f;
    }
    stage_g(0);
    cp_async_wait_all();
    __syncthreads();
    // read here, past the staging, so the prologue does not hold it
    const FixScale fs = fix_scale(words, npix * K);
    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) stage_g(t + 1);
      const float* gb = gs + (t & 1) * tp * ldg;
      const int t0 = start + t * tp;
      for (int item = threadIdx.x; item < stride_p * nk; item += blockDim.x) {
        const int pp = item % stride_p;
        const int kk = item / stride_p;
        const int k = k0 + kk;
        const float* wk = wt + kk * coutp * cgp;

        // gcols[h][c] = sum_o W[k, g*Cg + c, o] * g[row h, o], o ascending
        float gc[kRP][MAXCG];
#pragma unroll
        for (int h = 0; h < kRP; ++h) {
#pragma unroll
          for (int c = 0; c < MAXCG; ++c) gc[h][c] = 0.f;
        }
        for (int o = 0; o < coutp; o += 4) {
          float gv[kRP][4];
#pragma unroll
          for (int h = 0; h < kRP; ++h) {
            const float4 u =
                *reinterpret_cast<const float4*>(gb + (pp + h * stride_p) * ldg + o);
            gv[h][0] = u.x; gv[h][1] = u.y; gv[h][2] = u.z; gv[h][3] = u.w;
          }
#pragma unroll
          for (int oo = 0; oo < 4; ++oo) {
            const float* wr = wk + (o + oo) * cgp;
#pragma unroll
            for (int c4 = 0; c4 < MAXCG / 4; ++c4) {
              if (4 * c4 < cgp) {
                const float4 wv = *reinterpret_cast<const float4*>(wr + 4 * c4);
#pragma unroll
                for (int h = 0; h < kRP; ++h) {
                  gc[h][4 * c4 + 0] = fmaf(wv.x, gv[h][oo], gc[h][4 * c4 + 0]);
                  gc[h][4 * c4 + 1] = fmaf(wv.y, gv[h][oo], gc[h][4 * c4 + 1]);
                  gc[h][4 * c4 + 2] = fmaf(wv.z, gv[h][oo], gc[h][4 * c4 + 2]);
                  gc[h][4 * c4 + 3] = fmaf(wv.w, gv[h][oo], gc[h][4 * c4 + 3]);
                }
              }
            }
          }
        }

#pragma unroll
        for (int h = 0; h < kRP; ++h) {
          const int r = t0 + pp + h * stride_p;
          if (r >= end) continue;
          const Sample s = sample_at(off, G, r, g, k);
          const size_t q = ((size_t)r * G.dg + g) * K + k;
          const float m = mask[q];
          const size_t xrow = (size_t)(r / npix) * hw * G.Cin + g * cg;
          float dot[4];
          float gm = 0.f;
#pragma unroll
          for (int corner = 0; corner < 4; ++corner) {
            dot[corner] = 0.f;
            if (s.pix[corner] < 0) continue;
            const float scale = m * s.cw[corner];
            float d = 0.f;
            if constexpr (kOwn) {
              const float* xr = xs + s.pix[corner] * lds;
              unsigned* gr = gxs + 3 * s.pix[corner] * lds;
#pragma unroll
              for (int c = 0; c < MAXCG; ++c) {
                if (c < cg) {
                  d = fmaf(xr[c], gc[h][c], d);
                  shared_add_fix(gr + 3 * c, to_fix(scale * gc[h][c], fs));
                }
              }
            } else {
              // 4 channels at a time, the fence keeping one group's x in
              // registers (the compiler otherwise hoists every corner's
              // loads and spills at Cg 32)
              const size_t base = xrow + (size_t)s.pix[corner] * G.Cin;
#pragma unroll
              for (int c4 = 0; c4 < MAXCG / 4; ++c4) {
                if (4 * c4 >= cg) continue;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int c = 4 * c4 + i;
                  if (c < cg) d = fmaf(__ldg(x + base + c), gc[h][c], d);
                }
                unsigned long long* gr =
                    reinterpret_cast<unsigned long long*>(fix + base + 4 * c4);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  if (4 * c4 + i < cg) atomicAdd(gr + i, to_fix(scale * gc[h][4 * c4 + i], fs));
                }
                asm volatile("" ::: "memory");
              }
            }
            dot[corner] = d;
            gm = fmaf(s.cw[corner], d, gm);
          }
          gmask[q] = gm;
          // d/d(dy) and d/d(dx) of the four bilinear weights, times the
          // corner weights' cotangents m * <x[corner], gcols> (zero outside
          // the image)
          const float a0 = m * dot[0], a1 = m * dot[1], a2 = m * dot[2], a3 = m * dot[3];
          const float dy = s.dy, dx = s.dx;
          goff[2 * q] = (1.f - dx) * (a2 - a0) + dx * (a3 - a1);
          goff[2 * q + 1] = (1.f - dy) * (a1 - a0) + dy * (a3 - a2);
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }
  }

  if constexpr (kOwn) {
    const FixScale fs = fix_scale(words, npix * K);
    const size_t img = image_base();
    for (int e = threadIdx.x; e < hw * cg; e += blockDim.x) {
      const int pix = e / cg;
      const int c = e - pix * cg;
      gx[img + (size_t)pix * G.Cin + c] =
          from_fix(shared_fix_total(gxs + 3 * (pix * lds + c)), fs);
    }
  }
}

template <int MAXCG, bool kOwn>
int launch_bwd_pixel(const float* x, const float* off, const float* mask,
                     const float* w, const float* gout, float* gx, float* goff,
                     float* gmask, long long* fix, const unsigned* words,
                     const Geom& G, const BwdTile& T, void* stream) {
  const size_t smem = bwd_smem_bytes(G, T);
  cudaError_t err = allow_smem(dcn_bwd_pixel_kernel<MAXCG, kOwn>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = G.B * G.Ho * G.Wo;
  const dim3 grid((rows + T.chunk_rows - 1) / T.chunk_rows, G.dg);
  dcn_bwd_pixel_kernel<MAXCG, kOwn><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, off, mask, w, gout, gx, goff, gmask, fix, words, G, T);
  return (int)cudaGetLastError();
}

// The per-pixel backward at any width: the groups of more than 32 channels
// that the kernel above refuses (its gcols registers are sized by MAXCG),
// and a tap of W^T too wide for its shared memory (Cout in the thousands).
// Same results, other staging:
//   - a block owns `rows` rows of one group and scatters gx to the global
//     64-bit fixed-point accumulators; each thread owns
//     one (row, tap) item of a pass of kt taps (rows * kt <= kThreads);
//   - the group's channels run in chunks of kWideCC: per chunk a thread
//     holds that chunk's gcols in registers, scatters it, and carries its
//     four corner dots <x[corner], gcols> on to the next chunk, so goffsets
//     and gmask are one FMA chain over the channels in order, as above;
//   - W^T of the pass's taps and the cotangent rows are staged `to`
//     out-channels at a time, so the contraction over Cout (one FMA chain
//     per channel, out-channels ascending) takes any Cout.
// The cotangent is staged once per (pass, chunk, piece): at Cg > 32 it is
// read from L2 several times, against W^T staged once per block.
constexpr int kWideCC = 32;

struct BwdWideTile {
  int rows, kt, to;
};

// Mirrored by bwd_smem_bytes in ops/dcn_cuda.py (its wide branch).
size_t bwd_wide_smem_bytes(const BwdWideTile& T) {
  return ((size_t)T.kt * T.to * (kWideCC + 4) + (size_t)T.rows * (T.to + 4)) *
         sizeof(float);
}

bool bwd_wide_tile_ok(const BwdWideTile& T) {
  return T.rows >= 1 && T.kt >= 1 && T.rows * T.kt <= kThreads && T.to >= 4 &&
         T.to % 4 == 0 && bwd_wide_smem_bytes(T) <= 232448;
}

__global__ void __launch_bounds__(kThreads)
dcn_bwd_pixel_wide_kernel(const float* __restrict__ x, const float* __restrict__ off,
                          const float* __restrict__ mask,
                          const float* __restrict__ w,
                          const float* __restrict__ gout,
                          float* __restrict__ goff, float* __restrict__ gmask,
                          long long* __restrict__ fix,
                          const unsigned* __restrict__ words, Geom G,
                          BwdWideTile T) {
  extern __shared__ __align__(16) float smem[];
  constexpr int wst = kWideCC + 4;  // a W^T row: the chunk's channels, padded
  const int K = G.kh * G.kw;
  const int cg = G.Cin / G.dg;
  const int npix = G.Ho * G.Wo;
  const int hw = G.H * G.W;
  const int rows = G.B * npix;
  const int g = blockIdx.y;
  const int start = blockIdx.x * T.rows;
  const int end = min(rows, start + T.rows);
  const int ldg = T.to + 4;
  float* wt = smem;                    // [kt][to][wst]
  float* gs = wt + T.kt * T.to * wst;  // [rows][ldg]
  const bool vec_g = G.Cout % 4 == 0 && aligned16(gout);
  const FixScale fs = fix_scale(words, npix * K);
  // the thread's item: row start + pp, tap k0 + kk of each pass
  const int pp = threadIdx.x % T.rows;
  const int kk = threadIdx.x / T.rows;
  const int r = start + pp;

  for (int k0 = 0; k0 < K; k0 += T.kt) {
    const int nk = min(T.kt, K - k0);
    const int k = k0 + kk;
    const bool active = kk < nk && r < end;
    Sample s{};
    float m = 0.f;
    size_t q = 0, xrow = 0;
    if (active) {
      s = sample_at(off, G, r, g, k);
      q = ((size_t)r * G.dg + g) * K + k;
      m = mask[q];
      xrow = (size_t)(r / npix) * hw * G.Cin + g * cg;
    }
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < cg; c0 += kWideCC) {
      const int nc = min(kWideCC, cg - c0);
      // gcols[c] = sum_o W[k, g*Cg + c0 + c, o] * g[row, o], o ascending
      float gc[kWideCC];
#pragma unroll
      for (int c = 0; c < kWideCC; ++c) gc[c] = 0.f;
      for (int o0 = 0; o0 < G.Cout; o0 += T.to) {
        const int no = min(T.to, G.Cout - o0);
        const int nop = (no + 3) & ~3;
        __syncthreads();  // every thread is done with the last piece
        for (int e = threadIdx.x; e < nk * kWideCC * nop; e += blockDim.x) {
          const int o = e % nop;
          const int t = e / nop;
          const int c = t % kWideCC;
          const int j = t / kWideCC;
          wt[(j * T.to + o) * wst + c] =
              (o < no && c < nc)
                  ? __ldg(w + ((size_t)(k0 + j) * G.Cin + g * cg + c0 + c) * G.Cout + o0 + o)
                  : 0.f;
        }
        const int nv = nop / 4;
        for (int e = threadIdx.x; e < T.rows * nv; e += blockDim.x) {
          const int p = e / nv;
          const int o = (e - p * nv) * 4;
          const int rr = start + p;
          float* dst = gs + p * ldg + o;
          const float* src = gout + (size_t)rr * G.Cout + o0 + o;
          if (rr < end && vec_g && o + 4 <= no) {
            cp_async16(dst, src);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (rr < end && o + i < no) {
                cp_async4(dst + i, src + i);
              } else {
                dst[i] = 0.f;
              }
            }
          }
        }
        cp_async_wait_all();
        __syncthreads();
        if (active) {
          const float* wk = wt + kk * T.to * wst;
          const float* gr = gs + pp * ldg;
          for (int o = 0; o < nop; o += 4) {
            const float4 u = *reinterpret_cast<const float4*>(gr + o);
            const float gv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int oo = 0; oo < 4; ++oo) {
              const float* wr = wk + (o + oo) * wst;
#pragma unroll
              for (int c4 = 0; c4 < kWideCC / 4; ++c4) {
                if (4 * c4 < nc) {
                  const float4 wv = *reinterpret_cast<const float4*>(wr + 4 * c4);
                  gc[4 * c4 + 0] = fmaf(wv.x, gv[oo], gc[4 * c4 + 0]);
                  gc[4 * c4 + 1] = fmaf(wv.y, gv[oo], gc[4 * c4 + 1]);
                  gc[4 * c4 + 2] = fmaf(wv.z, gv[oo], gc[4 * c4 + 2]);
                  gc[4 * c4 + 3] = fmaf(wv.w, gv[oo], gc[4 * c4 + 3]);
                }
              }
            }
          }
        }
      }
      if (!active) continue;
      // scatter this chunk into gx and carry the corner dots on
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        if (s.pix[corner] < 0) continue;
        const float scale = m * s.cw[corner];
        const size_t base = xrow + (size_t)s.pix[corner] * G.Cin + c0;
        float d = dot[corner];
#pragma unroll
        for (int c4 = 0; c4 < kWideCC / 4; ++c4) {
          if (4 * c4 >= nc) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 4 * c4 + i;
            if (c < nc) d = fmaf(__ldg(x + base + c), gc[c], d);
          }
          unsigned long long* gr =
              reinterpret_cast<unsigned long long*>(fix + base + 4 * c4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * c4 + i < nc) atomicAdd(gr + i, to_fix(scale * gc[4 * c4 + i], fs));
          }
          asm volatile("" ::: "memory");
        }
        dot[corner] = d;
      }
    }
    if (active) {
      float gm = 0.f;
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        if (s.pix[corner] >= 0) gm = fmaf(s.cw[corner], dot[corner], gm);
      }
      gmask[q] = gm;
      const float a0 = m * dot[0], a1 = m * dot[1], a2 = m * dot[2], a3 = m * dot[3];
      const float dy = s.dy, dx = s.dx;
      goff[2 * q] = (1.f - dx) * (a2 - a0) + dx * (a3 - a1);
      goff[2 * q + 1] = (1.f - dy) * (a1 - a0) + dy * (a3 - a2);
    }
  }
}

int launch_bwd_pixel_wide(const float* x, const float* off, const float* mask,
                          const float* w, const float* gout, float* goff,
                          float* gmask, long long* fix, const unsigned* words,
                          const Geom& G, const BwdWideTile& T, void* stream) {
  const size_t smem = bwd_wide_smem_bytes(T);
  cudaError_t err = allow_smem(dcn_bwd_pixel_wide_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = G.B * G.Ho * G.Wo;
  const dim3 grid((rows + T.rows - 1) / T.rows, G.dg);
  dcn_bwd_pixel_wide_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, off, mask, w, gout, goff, gmask, fix, words, G, T);
  return (int)cudaGetLastError();
}

// The weight gradient's launch configuration: tj of the group's K*Cg
// columns (group-local j = k*Cg + c) x to out-channels per block, each
// thread a micro-tile of 4 columns x mo out-channels (mo / 4 quads, to / mo
// apart); chunk_rows rows per block, one partial of gW per chunk. A stage
// holds 2 * to / mo rows, so every thread gathers two 4-column items per
// stage.
struct WgradTile {
  int tj, to, mo, chunk_rows;
};

// Two stages of columns and cotangent rows. Mirrored by wgrad_smem_bytes in
// ops/dcn_cuda.py.
size_t wgrad_smem_bytes(const WgradTile& T) {
  const size_t stage_rows = 2 * (T.to / T.mo);
  return 2 * stage_rows * (T.tj + T.to) * sizeof(float);
}

bool wgrad_tile_ok(const WgradTile& T) {
  if (T.mo != 4 && T.mo != 8) return false;
  if (T.tj < 4 || T.tj % 4 != 0 || T.to < T.mo || T.to % T.mo != 0 || T.chunk_rows < 1) {
    return false;
  }
  return (T.tj / 4) * (T.to / T.mo) <= kThreads && wgrad_smem_bytes(T) <= 232448;
}

// Grid (row chunks, column tiles x out-channel tiles, groups). kVec: Cg % 4
// == 0 and x 16-byte aligned, so an item's 4 columns are 4 channels of one
// tap, sampled once and read as one float4 per corner, through the
// forward's pipeline (offsets and mask two stages ahead, corners one stage
// ahead and issued before the current stage's FMAs). Else an item's 4
// columns are sampled one by one when they are stored (a slow path for odd
// shapes).
template <bool kVec, int MO>
__global__ void __launch_bounds__(kThreads)
dcn_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ off,
                 const float* __restrict__ mask,
                 const float* __restrict__ gout, float* __restrict__ partial,
                 Geom G, WgradTile T) {
  extern __shared__ __align__(16) float smem[];
  const int K = G.kh * G.kw;
  const int cg = G.Cin / G.dg;
  const int kc = K * cg;
  const int tj = T.tj;
  const int to = T.to;
  const int nv = to / MO;    // threads along the out-channels
  const int nqj = tj / 4;    // column quads of the block
  const int tr = 2 * nv;     // rows per stage
  const int n_jt = (kc + tj - 1) / tj;
  const int g = blockIdx.z;
  const int j0 = (blockIdx.y % n_jt) * tj;
  const int o0 = (blockIdx.y / n_jt) * to;
  const int npix = G.Ho * G.Wo;
  const int rows = G.B * npix;
  const int start = blockIdx.x * T.chunk_rows;
  const int end = (int)min((long long)rows, (long long)start + T.chunk_rows);
  const int n_stages = (end - start + tr - 1) / tr;
  float* cs = smem;               // [2][tr][tj]
  float* gs = smem + 2 * tr * tj; // [2][tr][to]
  const bool vec_g = G.Cout % 4 == 0 && aligned16(gout);
  const size_t img = (size_t)G.H * G.W * G.Cin;
  const size_t rstride = (size_t)G.dg * K;  // a row's (group, tap) pairs

  // The thread's two gather items: rows p0 and p0 + nv of each stage, the
  // 4 columns j .. j+3 (fixed over the stages).
  const int jq = threadIdx.x % nqj;
  const int p0 = threadIdx.x / nqj;
  const int j = j0 + 4 * jq;
  const int k = j / cg;
  const int c = j - k * cg;
  const int ky = k / G.kw;
  const int kx = k - ky * G.kw;
  const int q = g * K + k;           // the item's (group, tap) in a row
  const int ch = g * cg + c;         // its first channel of x
  const bool col_ok = j < kc;

  auto item_row = [&](int s, int u) { return start + s * tr + p0 + u * nv; };

  auto load_pref_w = [&](Pref& P, int s, int u) {
    const int r = item_row(s, u);
    if (!col_ok || r >= end) return;
    const size_t e = (size_t)r * rstride + q;
    P.oy = off[2 * e];
    P.ox = off[2 * e + 1];
    P.m = mask[e];
  };

  auto issue_w = [&](Corners<4>& C, const Pref& P, int s, int u) {
    const int r = item_row(s, u);
    if (!col_ok || r >= end) return;
    const int b = r / npix;
    const int n = r - b * npix;
    const int oh = n / G.Wo;
    sample_corners<4>(C, P, x + b * img + ch, oh, n - oh * G.Wo, ky, kx, G);
  };

  // cs[p][j .. j+3] = m * sum_corner w_corner x[corner] (zero past the
  // chunk's end and past the group's columns)
  auto store_w = [&](float* cbuf, const Corners<4>& C, int s, int u) {
    const int r = item_row(s, u);
    const int p = p0 + u * nv;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < end) {
      if constexpr (kVec) {
        if (col_ok) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int cr = 0; cr < 4; ++cr) v[i] += C.v[cr][i] * C.cw[cr];
            v[i] *= C.m;
          }
        }
      } else {
        const float* xb = x + (size_t)(r / npix) * img + g * cg;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int jj = j + i;
          if (jj >= kc) continue;
          const int kk = jj / cg;
          const Sample sm = sample_at(off, G, r, g, kk);
#pragma unroll
          for (int cr = 0; cr < 4; ++cr) {
            if (sm.pix[cr] >= 0) {
              v[i] += xb[(size_t)sm.pix[cr] * G.Cin + jj - kk * cg] * sm.cw[cr];
            }
          }
          v[i] *= mask[(size_t)r * rstride + g * K + kk];
        }
      }
    }
    *reinterpret_cast<float4*>(cbuf + p * tj + 4 * jq) = make_float4(v[0], v[1], v[2], v[3]);
  };

  // the cotangent's rows of stage s, the block's out-channels, by
  // cp.async; zero past the chunk's end and past Cout
  auto stage_g = [&](float* gbuf, int s) {
    const int nq = to / 4;
    for (int e = threadIdx.x; e < tr * nq; e += blockDim.x) {
      const int p = e / nq;
      const int o4 = (e - p * nq) * 4;
      const int r = start + s * tr + p;
      const int o = o0 + o4;
      float* dst = gbuf + p * to + o4;
      const float* src = gout + (size_t)r * G.Cout + o;
      if (r < end && vec_g && o < G.Cout) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (r < end && o + i < G.Cout) {
            cp_async4(dst + i, src + i);
          } else {
            dst[i] = 0.f;
          }
        }
      }
    }
  };

  float acc[4][MO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int l = 0; l < MO; ++l) acc[i][l] = 0.f;
  }
  Pref P[2];
  Corners<4> C[2];

  if constexpr (kVec) {
#pragma unroll
    for (int u = 0; u < 2; ++u) load_pref_w(P[u], 0, u);
#pragma unroll
    for (int u = 0; u < 2; ++u) issue_w(C[u], P[u], 0, u);
    if (n_stages > 1) {
#pragma unroll
      for (int u = 0; u < 2; ++u) load_pref_w(P[u], 1, u);
    }
  }
  stage_g(gs, 0);
#pragma unroll
  for (int u = 0; u < 2; ++u) store_w(cs, C[u], 0, u);
  cp_async_wait_all();
  __syncthreads();

  const int tx = threadIdx.x % nv;
  const int ty = threadIdx.x / nv;
  for (int s = 0; s < n_stages; ++s) {
    const int nb = (s + 1) & 1;
    if (s + 1 < n_stages) {
      if constexpr (kVec) {
#pragma unroll
        for (int u = 0; u < 2; ++u) issue_w(C[u], P[u], s + 1, u);
        if (s + 2 < n_stages) {
#pragma unroll
          for (int u = 0; u < 2; ++u) load_pref_w(P[u], s + 2, u);
        }
      }
      stage_g(gs + nb * tr * to, s + 1);
    }
    // acc[i][4 m + l] += cols[p][4 ty + i] * g[p][4 tx + 4 nv m + l], rows
    // in order
    const float* cb = cs + (s & 1) * tr * tj + 4 * ty;
    const float* gb = gs + (s & 1) * tr * to + 4 * tx;
#pragma unroll(16 / MO)
    for (int p = 0; p < tr; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(cb + p * tj);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int m = 0; m < MO / 4; ++m) {
        const float4 bv = *reinterpret_cast<const float4*>(gb + p * to + 4 * nv * m);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * m + 0] = fmaf(av[i], bv.x, acc[i][4 * m + 0]);
          acc[i][4 * m + 1] = fmaf(av[i], bv.y, acc[i][4 * m + 1]);
          acc[i][4 * m + 2] = fmaf(av[i], bv.z, acc[i][4 * m + 2]);
          acc[i][4 * m + 3] = fmaf(av[i], bv.w, acc[i][4 * m + 3]);
        }
      }
    }
    if (s + 1 < n_stages) {
#pragma unroll
      for (int u = 0; u < 2; ++u) store_w(cs + nb * tr * tj, C[u], s + 1, u);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // partial[chunk][k][g*Cg + c][o], gW's own layout
  float* dst0 = partial + (size_t)blockIdx.x * K * G.Cin * G.Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int jj = j0 + 4 * ty + i;
    if (jj >= kc) continue;
    const int kk = jj / cg;
    float* dst = dst0 + ((size_t)kk * G.Cin + g * cg + jj - kk * cg) * G.Cout;
#pragma unroll
    for (int m = 0; m < MO / 4; ++m) {
      const int ob = o0 + 4 * tx + 4 * nv * m;
      if (G.Cout % 4 == 0 && aligned16(partial) && ob < G.Cout) {
        *reinterpret_cast<float4*>(dst + ob) = make_float4(
            acc[i][4 * m + 0], acc[i][4 * m + 1], acc[i][4 * m + 2], acc[i][4 * m + 3]);
      } else {
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (ob + l < G.Cout) dst[ob + l] = acc[i][4 * m + l];
        }
      }
    }
  }
}

template <bool kVec, int MO>
int launch_wgrad_mo(const float* x, const float* off, const float* mask,
                    const float* gout, float* partial, const Geom& G,
                    const WgradTile& T, const dim3& grid, void* stream) {
  const size_t smem = wgrad_smem_bytes(T);
  cudaError_t err = allow_smem(dcn_wgrad_kernel<kVec, MO>, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (T.tj / 4) * (T.to / MO);
  dcn_wgrad_kernel<kVec, MO><<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, off, mask, gout, partial, G, T);
  return (int)cudaGetLastError();
}

template <bool kVec>
int launch_wgrad(const float* x, const float* off, const float* mask,
                 const float* gout, float* partial, const Geom& G,
                 const WgradTile& T, const dim3& grid, void* stream) {
  return T.mo == 8
             ? launch_wgrad_mo<kVec, 8>(x, off, mask, gout, partial, G, T, grid, stream)
             : launch_wgrad_mo<kVec, 4>(x, off, mask, gout, partial, G, T, grid, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after its launch: 0 on success, cudaErrorInvalidValue for a configuration
// the kernel does not take. The caller allocates every output and picks the
// launch configurations (ops/dcn_cuda.py: fwd_config, bwd_config,
// wgrad_config).

extern "C" int dcn_train_fwd_f32(const float* x, const float* off,
                                 const float* mask, const float* w,
                                 const float* bias, float* out, int B, int H,
                                 int W, int Cin, int Ho, int Wo, int Cout,
                                 int dg, int kh, int kw, int stride, int pad,
                                 int dil, int tm, int tn, int rm,
                                 void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  return launch_dcn_forward<false>(x, off, mask, w, bias, out, G,
                                   FwdTile{tm, tn, rm}, Activity{}, stream);
}

// The activity-predicated train forward (replaces _dcn_kernel_masked); the
// bitmap as in dcn_fwd_masked_f32. Its backward is the dense pair below.
extern "C" int dcn_train_fwd_masked_f32(
    const float* x, const float* off, const float* mask, const float* w,
    const float* bias, float* out, const int* am, int B, int H, int W,
    int Cin, int Ho, int Wo, int Cout, int dg, int kh, int kw, int stride,
    int pad, int dil, int tm, int tn, int rm, int n_tiles,
    int no_tile, void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  return launch_dcn_forward<true>(x, off, mask, w, bias, out, G,
                                  FwdTile{tm, tn, rm},
                                  Activity{am, n_tiles, no_tile}, stream);
}

// gx, goffsets and gmask; every element of each is written. scratch is
// 2 + (own ? 0 : B*H*W*Cin) 64-bit words: the bound words, then the global
// fixed-point accumulators of gx; this entry zeroes it. to > 0 selects the
// wide kernel (rows = chunk_rows = tp per block, kt taps per pass, W^T and
// the cotangent staged to out-channels at a time; own must be 0). Launches
// the bound pass, the per-pixel kernel and, off the ownership path, the
// conversion of the accumulators to gx, in that order on the stream.
extern "C" int dcn_bwd_pixel_f32(const float* x, const float* off,
                                 const float* mask, const float* w,
                                 const float* gout, float* gx, float* goff,
                                 float* gmask, long long* scratch, int B, int H,
                                 int W, int Cin, int Ho, int Wo, int Cout,
                                 int dg, int kh, int kw, int stride, int pad,
                                 int dil, int chunk_rows, int tp, int kt, int own,
                                 int to, void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  const int cg = geom_ok(G) ? Cin / dg : 0;
  const BwdWideTile WT{tp, kt, to};
  const BwdTile T{chunk_rows, tp, kt, own};
  if (to > 0) {
    if (!geom_ok(G) || own != 0 || chunk_rows != tp || kt > kh * kw ||
        !bwd_wide_tile_ok(WT)) {
      return (int)cudaErrorInvalidValue;
    }
  } else if (!geom_ok(G) || cg > 32 || tp < 2 || tp % 2 != 0 || kt < 1 ||
             kt > kh * kw || chunk_rows < 1 ||
             (own != 0 && (chunk_rows != Ho * Wo || Ho * Wo * kh * kw >= 65536)) ||
             bwd_smem_bytes(G, T) > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const long long ngx = (long long)B * H * W * Cin;
  unsigned* words = reinterpret_cast<unsigned*>(scratch);
  long long* fix = scratch + 2;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(2 + (own ? 0 : ngx)) * 8, st);
  if (err != cudaSuccess) return (int)err;
  const long long ng = (long long)B * Ho * Wo * Cout;
  const long long nm = (long long)B * Ho * Wo * dg * kh * kw;
  const int bound_blocks = (int)std::min<long long>(264, (ng + kThreads - 1) / kThreads);
  dcn_bwd_bound_kernel<<<std::max(bound_blocks, 1), kThreads, 0, st>>>(
      gout, ng, mask, nm, w, kh * kw * Cin, Cout, words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int rc;
  if (to > 0) {
    rc = launch_bwd_pixel_wide(x, off, mask, w, gout, goff, gmask, fix, words, G, WT, stream);
  } else if (cg <= 8) {
    rc = own ? launch_bwd_pixel<8, true>(x, off, mask, w, gout, gx, goff, gmask, fix, words, G, T, stream)
             : launch_bwd_pixel<8, false>(x, off, mask, w, gout, gx, goff, gmask, fix, words, G, T, stream);
  } else {
    rc = own ? launch_bwd_pixel<32, true>(x, off, mask, w, gout, gx, goff, gmask, fix, words, G, T, stream)
             : launch_bwd_pixel<32, false>(x, off, mask, w, gout, gx, goff, gmask, fix, words, G, T, stream);
  }
  if (rc != 0 || own) return rc;
  const int conv_blocks = (int)std::min<long long>(1056, (ngx + kThreads - 1) / kThreads);
  dcn_bwd_fix_to_float_kernel<<<std::max(conv_blocks, 1), kThreads, 0, st>>>(
      fix, ngx, words, Ho * Wo * kh * kw, gx);
  return (int)cudaGetLastError();
}
extern "C" int dcn_wgrad_f32(const float* x, const float* off,
                             const float* mask, const float* gout,
                             float* partial, int B, int H, int W, int Cin,
                             int Ho, int Wo, int Cout, int dg, int kh, int kw,
                             int stride, int pad, int dil, int tj, int to,
                             int mo, int chunk_rows, void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  const WgradTile T{tj, to, mo, chunk_rows};
  if (!geom_ok(G) || !wgrad_tile_ok(T) || B < 1 || Ho < 1 || Wo < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // rows and the grid's y (column x out-channel tiles) and z (groups) limits
  const long long rows = (long long)B * Ho * Wo;
  const long long kc = (long long)kh * kw * (Cin / dg);
  const long long tiles = ((kc + tj - 1) / tj) * ((Cout + to - 1) / to);
  if (rows >= (1LL << 31) || tiles > 65535 || dg > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((rows + chunk_rows - 1) / chunk_rows), (unsigned)tiles,
                  (unsigned)dg);
  const bool vec = (Cin / dg) % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  return vec ? launch_wgrad<true>(x, off, mask, gout, partial, G, T, grid, stream)
             : launch_wgrad<false>(x, off, mask, gout, partial, G, T, grid, stream);
}
