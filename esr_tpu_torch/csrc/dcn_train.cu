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
//   3. dcn_wgrad_kernel: grid (row chunks, groups). Each block walks its
//      chunk in tiles of kRows rows, rebuilds cols for its group and
//      accumulates gW[g] = sum_r cols[r, j] g[r, o] in registers, then
//      writes one partial per chunk; the wrapper sums the partials in a
//      fixed order (the second pass of the reduction over B*Ho*Wo rows that
//      the TPU kernel carries across its sequential grid).
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
//     accumulator for the group in shared memory (H*W*Cg floats each, rows
//     padded to Cg + 1 so neighbouring pixels hit different banks), stages
//     W[:, group] once as W^T [tap][o][c], and streams the image's cotangent
//     rows through shared memory in double-buffered cp.async tiles.
//   - gcols is register-blocked: a thread holds 2 rows (1 at Cg > 8, for
//     registers) x one tap x all Cg channels, so per 4 out-channels it
//     loads 2 float4 of g and Cg float4 of W (broadcast) for 8*Cg FMAs, and
//     the scatter comes straight from registers: shared-memory atomicAdd
//     into the gx slice, x corners read from the x slice. On the H100 a
//     shared f32 atomicAdd is a CAS loop (ATOMS.CAST.SPIN), about half the
//     kernel's time at the flagship.
//   - At the end the block writes its gx slice with plain stores: every
//     element of gx has exactly one writer, so gx needs no zeroing.
//   - An image whose slices do not fit shared memory takes the other
//     instantiation (kOwn = false): blocks of rows, x read from global, and
//     gx scattered to global with float4 atomics (vector red, sm_90) when
//     Cg % 4 == 0; the caller zeroes gx for it. When W^T of all taps does
//     not fit, the taps run in passes (kt per pass), the cotangent streamed
//     once per pass. The chooser in ops/dcn_cuda.py picks from the shape.
//
// Determinism: the forward, goffsets, gmask and gW are run-to-run
// deterministic (fixed summation order; goffsets and gmask use the same
// per-element operation order as the earlier kernel). gx is not: shared or
// global atomics add in an order that changes between runs, so gx may
// differ in the last bits. Measured times are in PERF.md (chip_smoke.py).

#include "dcn_common.cuh"

namespace {

constexpr int kRows = 32;       // rows per tile in the weight gradient
constexpr int kWgradAcc = 32;   // outputs per thread in the weight gradient

// The per-pixel backward's launch configuration: chunk_rows rows per block
// (one image when own), tp cotangent rows per shared tile, kt taps per
// pass, own = the x / gx slices live in shared memory.
struct BwdTile {
  int chunk_rows, tp, kt, own;
};

// Mirrored by bwd_smem_bytes in ops/dcn_cuda.py.
size_t bwd_smem_bytes(const Geom& G, const BwdTile& T) {
  const size_t cg = G.Cin / G.dg;
  const size_t cgp = (cg + 3) / 4 * 4;
  const size_t coutp = ((size_t)G.Cout + 3) / 4 * 4;
  const size_t nbuf = (T.chunk_rows + T.tp - 1) / T.tp > 1 ? 2 : 1;
  size_t f = (size_t)T.kt * coutp * cgp + nbuf * T.tp * (coutp + 4);
  if (T.own) f += 2 * (size_t)G.H * G.W * (cg + 1);
  return f * sizeof(float);
}

// MAXCG bounds the per-thread gcols registers; the caller picks the
// smallest instantiation with Cg <= MAXCG.
template <int MAXCG, bool kOwn>
__global__ void __launch_bounds__(kThreads)
dcn_bwd_pixel_kernel(const float* __restrict__ x, const float* __restrict__ off,
                     const float* __restrict__ mask,
                     const float* __restrict__ w,
                     const float* __restrict__ gout, float* gx,
                     float* __restrict__ goff, float* __restrict__ gmask,
                     Geom G, BwdTile T) {
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
  float* wt = smem;                        // [kt][coutp][cgp]
  float* gs = wt + T.kt * coutp * cgp;     // [nbuf][tp][ldg]
  float* xs = gs + nbuf * tp * ldg;        // [hw][lds]   (kOwn)
  float* gxs = xs + hw * lds;              // [hw][lds]   (kOwn)
  const bool vec_g = G.Cout % 4 == 0 && aligned16(gout);
  const bool vec_gx = !kOwn && cg % 4 == 0 && aligned16(gx);
  // the image's channels of this group (kOwn: the block's rows are one image)
  const size_t img = (size_t)(start / npix) * hw * G.Cin + g * cg;

  if constexpr (kOwn) {
    for (int e = threadIdx.x; e < hw * cg; e += blockDim.x) {
      const int pix = e / cg;
      const int c = e - pix * cg;
      xs[pix * lds + c] = x[img + (size_t)pix * G.Cin + c];
      gxs[pix * lds + c] = 0.f;
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
              float* gr = gxs + s.pix[corner] * lds;
#pragma unroll
              for (int c = 0; c < MAXCG; ++c) {
                if (c < cg) {
                  d = fmaf(xr[c], gc[h][c], d);
                  atomicAdd(gr + c, scale * gc[h][c]);
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
                if (vec_gx) {
                  atomicAdd(reinterpret_cast<float4*>(gx + base + 4 * c4),
                            make_float4(scale * gc[h][4 * c4 + 0],
                                        scale * gc[h][4 * c4 + 1],
                                        scale * gc[h][4 * c4 + 2],
                                        scale * gc[h][4 * c4 + 3]));
                } else {
#pragma unroll
                  for (int i = 0; i < 4; ++i) {
                    const int c = 4 * c4 + i;
                    if (c < cg) atomicAdd(gx + base + c, scale * gc[h][c]);
                  }
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
    for (int e = threadIdx.x; e < hw * cg; e += blockDim.x) {
      const int pix = e / cg;
      const int c = e - pix * cg;
      gx[img + (size_t)pix * G.Cin + c] = gxs[pix * lds + c];
    }
  }
}

template <int MAXCG, bool kOwn>
int launch_bwd_pixel(const float* x, const float* off, const float* mask,
                     const float* w, const float* gout, float* gx, float* goff,
                     float* gmask, const Geom& G, const BwdTile& T,
                     void* stream) {
  const size_t smem = bwd_smem_bytes(G, T);
  cudaError_t err = allow_smem(dcn_bwd_pixel_kernel<MAXCG, kOwn>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = G.B * G.Ho * G.Wo;
  const dim3 grid((rows + T.chunk_rows - 1) / T.chunk_rows, G.dg);
  dcn_bwd_pixel_kernel<MAXCG, kOwn><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, off, mask, w, gout, gx, goff, gmask, G, T);
  return (int)cudaGetLastError();
}

// cols[p][j], j = k*Cg + c, for rows r0 + p (< r_end) of group g: the mask
// times the bilinear sample of channel g*Cg + c at tap k, zero past r_end.
// One (row, tap, channel) element per thread step.
__device__ __forceinline__ void fill_cols(float* cols,
                                          const float* __restrict__ x,
                                          const float* __restrict__ off,
                                          const float* __restrict__ mask,
                                          const Geom& G, int g, int r0,
                                          int r_end, int tile) {
  const int K = G.kh * G.kw;
  const int cg = G.Cin / G.dg;
  const int KC = K * cg;
  const int npix = G.Ho * G.Wo;
  for (int e = threadIdx.x; e < tile * KC; e += kThreads) {
    const int p = e / KC;
    const int j = e - p * KC;
    const int k = j / cg;
    const int c = j - k * cg;
    const int r = r0 + p;
    float v = 0.f;
    if (r < r_end) {
      const Sample s = sample_at(off, G, r, g, k);
      const float* xb =
          x + (size_t)(r / npix) * G.H * G.W * G.Cin + g * cg + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (s.pix[q] >= 0) v += xb[(size_t)s.pix[q] * G.Cin] * s.cw[q];
      }
      v *= mask[((size_t)r * G.dg + g) * K + k];
    }
    cols[e] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
dcn_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ off,
                 const float* __restrict__ mask,
                 const float* __restrict__ gout, float* __restrict__ partial,
                 Geom G, int chunk_rows) {
  extern __shared__ __align__(16) float smem[];
  const int K = G.kh * G.kw;
  const int cg = G.Cin / G.dg;
  const int KC = K * cg;
  const int Cout = G.Cout;
  const int g = blockIdx.y;
  float* cols = smem;               // [kRows][KC]
  float* gs = smem + kRows * KC;    // [kRows][Cout]
  const int rows = G.B * G.Ho * G.Wo;
  const int start = blockIdx.x * chunk_rows;
  const int end = min(rows, start + chunk_rows);
  const int tid = threadIdx.x;
  const int n_out = KC * Cout;

  float acc[kWgradAcc];
#pragma unroll
  for (int i = 0; i < kWgradAcc; ++i) acc[i] = 0.f;

  for (int t0 = start; t0 < end; t0 += kRows) {
    fill_cols(cols, x, off, mask, G, g, t0, end, kRows);
    for (int e = tid; e < kRows * Cout; e += kThreads) {
      const int p = e / Cout;
      const int o = e - p * Cout;
      gs[e] = t0 + p < end ? gout[(size_t)(t0 + p) * Cout + o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kWgradAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < n_out) {
        const int j = idx / Cout;
        const int o = idx - j * Cout;
        float a = acc[i];
#pragma unroll 8
        for (int p = 0; p < kRows; ++p) {
          a = fmaf(cols[p * KC + j], gs[p * Cout + o], a);
        }
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  float* dst = partial + (size_t)blockIdx.x * K * G.Cin * Cout;
#pragma unroll
  for (int i = 0; i < kWgradAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < n_out) {
      const int j = idx / Cout;
      const int o = idx - j * Cout;
      const int k = j / cg;
      const int c = j - k * cg;
      dst[((size_t)k * G.Cin + g * cg + c) * Cout + o] = acc[i];
    }
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after its launch: 0 on success, cudaErrorInvalidValue for a configuration
// the kernel does not take. The caller allocates every output and picks the
// launch configurations (ops/dcn_cuda.py: fwd_config, bwd_config).

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

// gx must be zeroed by the caller when own == 0 (global scatter); with
// own == 1 every element of gx is written once.
extern "C" int dcn_bwd_pixel_f32(const float* x, const float* off,
                                 const float* mask, const float* w,
                                 const float* gout, float* gx, float* goff,
                                 float* gmask, int B, int H, int W, int Cin,
                                 int Ho, int Wo, int Cout, int dg, int kh,
                                 int kw, int stride, int pad, int dil,
                                 int chunk_rows, int tp, int kt, int own,
                                 void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  const BwdTile T{chunk_rows, tp, kt, own};
  const int cg = geom_ok(G) ? Cin / dg : 0;
  if (!geom_ok(G) || cg > 32 || tp < 2 || tp % 2 != 0 || kt < 1 ||
      kt > kh * kw || chunk_rows < 1 || (own != 0 && chunk_rows != Ho * Wo) ||
      bwd_smem_bytes(G, T) > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  if (cg <= 8) {
    return own ? launch_bwd_pixel<8, true>(x, off, mask, w, gout, gx, goff, gmask, G, T, stream)
               : launch_bwd_pixel<8, false>(x, off, mask, w, gout, gx, goff, gmask, G, T, stream);
  }
  return own ? launch_bwd_pixel<32, true>(x, off, mask, w, gout, gx, goff, gmask, G, T, stream)
             : launch_bwd_pixel<32, false>(x, off, mask, w, gout, gx, goff, gmask, G, T, stream);
}

extern "C" int dcn_wgrad_f32(const float* x, const float* off,
                             const float* mask, const float* gout,
                             float* partial, int B, int H, int W, int Cin,
                             int Ho, int Wo, int Cout, int dg, int kh, int kw,
                             int stride, int pad, int dil, int chunk_rows,
                             int n_chunks, void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  if (!geom_ok(G) || chunk_rows < 1 || n_chunks < 1 ||
      kh * kw * (Cin / dg) * Cout > kThreads * kWgradAcc) {
    return (int)cudaErrorInvalidValue;
  }
  const int KC = kh * kw * (Cin / dg);
  const size_t smem = (size_t)kRows * (KC + Cout) * sizeof(float);
  cudaError_t err = allow_smem(dcn_wgrad_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dcn_wgrad_kernel<<<dim3(n_chunks, dg), kThreads, smem,
                     (cudaStream_t)stream>>>(x, off, mask, gout, partial, G,
                                             chunk_rows);
  return (int)cudaGetLastError();
}

// Launch geometry constants of the weight gradient, so the Python wrapper
// sizes its chunks from the library it actually loaded.
extern "C" int dcn_train_threads(void) { return kThreads; }
extern "C" int dcn_train_rows_per_tile(void) { return kRows; }
extern "C" int dcn_train_wgrad_acc(void) { return kWgradAcc; }
