// Modulated deformable convolution (DCNv2), the train direction, f32, for
// Hopper (sm_90a): the forward that autograd saves for, and its backward.
//
// Replaces two TPU kernels of esr_tpu/ops/dcn_pallas.py:
//   - _dcn_kernel (tile body _dcn_tile_acc), the forward of the op
//     deform_conv2d_pallas, which recasts the bilinear gather as a 4-corner
//     one-hot matrix S[hw, o] on the MXU;
//   - _dcn_bwd_kernel, its fused backward (custom_vjp _bwd), which rebuilds
//     S and gets gx = col2im(W^T g), gW = sum_o cols g^T and the per-corner
//     weight cotangents from transposed MXU products.
// Each thread here gathers directly: the one-hot products exist only because
// a per-lane scalar gather does not map to the TPU's vector units.
//
// Layouts, the bilinear sampling and the column tile are in dcn_common.cuh.
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
//   2. dcn_bwd_pixel_kernel: one thread per (row, group, tap), pixels
//      fastest so a warp reads one W row (a broadcast). It forms
//      gcols[c] = sum_o W[k, g*Cg+c, o] g[r, o], scatters m*w_corner*gcols
//      into gx with atomicAdd (learned offsets make the col2im irregular),
//      and, fused, the VJP through the corner weights that
//      _corner_pairs/jax.vjp does in the reference: gmask = sum_corner
//      w_corner <x[corner], gcols>, and d/d(dy, dx) of the bilinear weights
//      times m <x[corner], gcols> for goffsets (zero outside the image).
//   3. dcn_wgrad_kernel: grid (row chunks, groups). Each block walks its
//      chunk in tiles of kRows rows, rebuilds cols for its group and
//      accumulates gW[g] = sum_r cols[r, j] g[r, o] in registers, then
//      writes one partial per chunk; the wrapper sums the partials in a
//      fixed order (the second pass of the reduction over B*Ho*Wo rows that
//      the TPU kernel carries across its sequential grid).
// All accumulation is f32 FMAs (no TF32).
//
// Determinism: the forward, goffsets, gmask and gW are run-to-run
// deterministic (fixed summation order). gx is not: its atomicAdd order
// changes between runs, so gx may differ in the last bits.
//
// Bound at the flagship training call (x [32,12,20,64], dg 8, K 9, Cout 64,
// 7680 rows): each of the three does one contraction of 2*7680*576*64 =
// 566 MFLOP, 8.5 us at the H100's 67 TFLOP/s f32 rate; the bytes are
// ~7-12 MB, 2-4 us at 3.35 TB/s. So all three are bound by operations.
// Their measured times are in PERF.md (chip_smoke.py).

#include "dcn_common.cuh"

namespace {

constexpr int kRows = 32;       // rows per tile in both backward kernels
constexpr int kWgradAcc = 32;   // outputs per thread in the weight gradient

// MAXCG bounds the per-thread gcols registers; the caller picks the
// smallest instantiation with Cg <= MAXCG.
template <int MAXCG>
__global__ void __launch_bounds__(kThreads)
dcn_bwd_pixel_kernel(const float* __restrict__ x, const float* __restrict__ off,
                     const float* __restrict__ mask,
                     const float* __restrict__ w,
                     const float* __restrict__ gout, float* gx,
                     float* __restrict__ goff, float* __restrict__ gmask,
                     Geom G, int tile) {
  extern __shared__ float smem[];
  const int K = G.kh * G.kw;
  const int cg = G.Cin / G.dg;
  const int Cout = G.Cout;
  const int ld = Cout + 1;  // padded row: lanes on neighbouring rows hit distinct banks
  const int npix = G.Ho * G.Wo;
  const int rows = G.B * npix;
  const int r0 = blockIdx.x * tile;
  float* gs = smem;  // [tile][Cout + 1]
  for (int e = threadIdx.x; e < tile * Cout; e += kThreads) {
    const int p = e / Cout;
    const int o = e - p * Cout;
    gs[p * ld + o] = r0 + p < rows ? gout[(size_t)(r0 + p) * Cout + o] : 0.f;
  }
  __syncthreads();

  for (int item = threadIdx.x; item < tile * G.dg * K; item += kThreads) {
    const int p = item % tile;
    const int gk = item / tile;
    const int g = gk / K;
    const int k = gk - g * K;
    const int r = r0 + p;
    if (r >= rows) continue;

    // gcols[c] = sum_o W[k, g*Cg + c, o] * g[r, o]
    float gc[MAXCG];
#pragma unroll
    for (int c = 0; c < MAXCG; ++c) gc[c] = 0.f;
    const float* wk = w + ((size_t)k * G.Cin + g * cg) * Cout;
    const float* gr = gs + p * ld;
    for (int o = 0; o < Cout; ++o) {
      const float gv = gr[o];
#pragma unroll
      for (int c = 0; c < MAXCG; ++c) {
        if (c < cg) gc[c] = fmaf(__ldg(wk + (size_t)c * Cout + o), gv, gc[c]);
      }
    }

    const Sample s = sample_at(off, G, r, g, k);
    const size_t q = ((size_t)r * G.dg + g) * K + k;
    const float m = mask[q];
    const size_t img = (size_t)(r / npix) * G.H * G.W * G.Cin + g * cg;
    float dot[4];
    float gm = 0.f;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      dot[corner] = 0.f;
      if (s.pix[corner] >= 0) {
        const size_t base = img + (size_t)s.pix[corner] * G.Cin;
        const float scale = m * s.cw[corner];
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < MAXCG; ++c) {
          if (c < cg) {
            d = fmaf(x[base + c], gc[c], d);
            atomicAdd(gx + base + c, scale * gc[c]);
          }
        }
        dot[corner] = d;
        gm = fmaf(s.cw[corner], d, gm);
      }
    }
    gmask[q] = gm;
    // d/d(dy) and d/d(dx) of the four bilinear weights, times the corner
    // weights' cotangents m * <x[corner], gcols> (zero outside the image)
    const float a0 = m * dot[0], a1 = m * dot[1], a2 = m * dot[2], a3 = m * dot[3];
    const float dy = s.dy, dx = s.dx;
    goff[2 * q] = (1.f - dx) * (a2 - a0) + dx * (a3 - a1);
    goff[2 * q + 1] = (1.f - dy) * (a1 - a0) + dy * (a3 - a2);
  }
}

__global__ void __launch_bounds__(kThreads)
dcn_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ off,
                 const float* __restrict__ mask,
                 const float* __restrict__ gout, float* __restrict__ partial,
                 Geom G, int chunk_rows) {
  extern __shared__ float smem[];
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
    fill_cols<false>(cols, x, off, mask, G, g, t0, end, kRows, Activity{});
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
// after its launch: 0 on success. The caller allocates every output (gx
// zeroed) and sizes the tiles within the limits the query functions give.

extern "C" int dcn_train_fwd_f32(const float* x, const float* off,
                                 const float* mask, const float* w,
                                 const float* bias, float* out, int B, int H,
                                 int W, int Cin, int Ho, int Wo, int Cout,
                                 int dg, int kh, int kw, int stride, int pad,
                                 int dil, int tile, void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  return launch_dcn_forward<false>(x, off, mask, w, bias, out, G, tile,
                                   Activity{}, stream);
}

// The activity-predicated train forward (replaces _dcn_kernel_masked); the
// bitmap as in dcn_fwd_masked_f32. Its backward is the dense pair below.
extern "C" int dcn_train_fwd_masked_f32(
    const float* x, const float* off, const float* mask, const float* w,
    const float* bias, float* out, const int* am, int B, int H, int W,
    int Cin, int Ho, int Wo, int Cout, int dg, int kh, int kw, int stride,
    int pad, int dil, int tile, int n_tiles, int no_tile, void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  return launch_dcn_forward<true>(x, off, mask, w, bias, out, G, tile,
                                  Activity{am, n_tiles, no_tile}, stream);
}

extern "C" int dcn_bwd_pixel_f32(const float* x, const float* off,
                                 const float* mask, const float* w,
                                 const float* gout, float* gx, float* goff,
                                 float* gmask, int B, int H, int W, int Cin,
                                 int Ho, int Wo, int Cout, int dg, int kh,
                                 int kw, int stride, int pad, int dil,
                                 int tile, void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  const int cg = geom_ok(G) ? Cin / dg : 0;
  if (!geom_ok(G) || tile < 1 || cg > 32) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile * (Cout + 1) * sizeof(float);
  const int rows = B * Ho * Wo;
  const dim3 grid((rows + tile - 1) / tile);
  cudaError_t err;
  if (cg <= 8) {
    err = allow_smem(dcn_bwd_pixel_kernel<8>, smem);
    if (err != cudaSuccess) return (int)err;
    dcn_bwd_pixel_kernel<8><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        x, off, mask, w, gout, gx, goff, gmask, G, tile);
  } else {
    err = allow_smem(dcn_bwd_pixel_kernel<32>, smem);
    if (err != cudaSuccess) return (int)err;
    dcn_bwd_pixel_kernel<32><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        x, off, mask, w, gout, gx, goff, gmask, G, tile);
  }
  return (int)cudaGetLastError();
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

// Launch geometry constants, so the Python wrapper sizes tiles from the
// library it actually loaded.
extern "C" int dcn_train_threads(void) { return kThreads; }
extern "C" int dcn_train_rows_per_tile(void) { return kRows; }
extern "C" int dcn_train_fwd_acc(void) { return kFwdAcc; }
extern "C" int dcn_train_wgrad_acc(void) { return kWgradAcc; }
extern "C" int dcn_train_bwd_max_cg(void) { return 32; }
