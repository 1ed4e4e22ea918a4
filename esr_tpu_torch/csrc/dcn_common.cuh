// Shared device code of the DCNv2 kernels (f32, Hopper sm_90a): the
// bilinear sampling, the column tile, and the one forward body that both
// forward entry points launch (dcn_fwd_f32 in dcn_fwd.cu, the forward
// direction; dcn_train_fwd_f32 in dcn_train.cu, the train direction). Each
// .cu file includes this header and gets its own copy.
//
// Layouts (the reference's, channel-last), rows r = flattened (b, ho, wo):
//   x       [B, H, W, Cin]
//   offsets [B, Ho, Wo, dg, K, 2]   (dy, dx) per output pixel, group, tap
//   mask    [B, Ho, Wo, dg, K]      already sigmoid'd
//   weight  [kh, kw, Cin, Cout]     HWIO; Cin splits (dg, Cg), dg-major
//   bias    [Cout] or null
//   g, out  [B, Ho, Wo, Cout]
//
// The forward body: one block per tile of `tile` rows (the batch is
// flattened into the rows; the caller picks the tile so that the grid
// fills the card). Per group, all threads build the column tile
// cols[tile][K*Cg] in shared memory (one (row, tap, channel) element per
// thread step: the mask times the bilinear sample, zero outside the image,
// the boundary rule of esr_tpu/ops/dcn.py:_bilinear_gather), W[g] is staged
// as [K*Cg][Cout], and each thread accumulates its (row, out-channel)
// outputs in registers with f32 FMAs (no TF32). The bias is added in the
// epilogue; the column tensor never goes to global memory.
//
// The masked body (kMasked = true) is the activity-predicated twin of
// esr_tpu/ops/dcn_pallas.py:_dcn_fwd_kernel_masked / _dcn_kernel_masked:
// an int32 bitmap am[B][n_tiles] marks which (image, output tile) pairs
// are active, output pixel n of an image lying in tile n / no_tile. Rows
// are flattened across images, so a block's tile of rows may straddle
// images and tiles: the predicate is per row. An inactive row builds no
// column (x, offsets and mask are not read) and its output is selected as
// 0 + bias, whatever the FMAs give (a non-finite W would make them NaN); a
// block whose rows are all inactive skips W staging and the FMA loop. On
// an active row the masked body runs the dense body's arithmetic, so on a
// truthful mask (an inactive image is all zero) the two agree bitwise.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFwdAcc = 8;  // outputs per thread in the forward

struct Geom {
  int B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil;
};

// The activity bitmap of the masked body (unused by the dense one).
struct Activity {
  const int* am;  // [B][n_tiles], nonzero = active
  int n_tiles;
  int no_tile;    // output pixels per tile
};

__device__ __forceinline__ bool row_active(const Activity& A, const Geom& G,
                                           int r) {
  const int npix = G.Ho * G.Wo;
  const int b = r / npix;
  return A.am[b * A.n_tiles + (r - b * npix) / A.no_tile] != 0;
}

// Where one (row, group, tap) samples: the four corners' flat input pixel
// (y*W + x, or -1 outside the image) in the reference's corner order
// (0,0), (0,1), (1,0), (1,1), their bilinear weights (not masked) and the
// fractional parts.
struct Sample {
  int pix[4];
  float cw[4];
  float dy, dx;
};

__device__ __forceinline__ Sample sample_at(const float* __restrict__ off,
                                            const Geom& G, int r, int g,
                                            int k) {
  const int npix = G.Ho * G.Wo;
  const int n = r % npix;
  const int oh = n / G.Wo;
  const int ow = n - oh * G.Wo;
  const int ky = k / G.kw;
  const int kx = k - ky * G.kw;
  const size_t q = ((size_t)r * G.dg + g) * (G.kh * G.kw) + k;
  const float ys = (float)(oh * G.stride - G.pad + ky * G.dil) + off[2 * q];
  const float xs = (float)(ow * G.stride - G.pad + kx * G.dil) + off[2 * q + 1];
  const float fy = floorf(ys);
  const float fx = floorf(xs);
  Sample s;
  s.dy = ys - fy;
  s.dx = xs - fx;
  s.cw[0] = (1.f - s.dy) * (1.f - s.dx);
  s.cw[1] = (1.f - s.dy) * s.dx;
  s.cw[2] = s.dy * (1.f - s.dx);
  s.cw[3] = s.dy * s.dx;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float cy = fy + (float)(c >> 1);
    const float cx = fx + (float)(c & 1);
    // float compares: a NaN or huge offset never reaches an int cast
    const bool ok = cy >= 0.f && cy <= (float)(G.H - 1) && cx >= 0.f &&
                    cx <= (float)(G.W - 1);
    s.pix[c] = ok ? (int)cy * G.W + (int)cx : -1;
  }
  return s;
}

// cols[p][j], j = k*Cg + c, for rows r0 + p (< r_end) of group g: the
// mask times the bilinear sample of channel g*Cg + c at tap k; zero past
// r_end and, when kMasked, on inactive rows. One (row, tap, channel)
// element per thread step.
template <bool kMasked>
__device__ __forceinline__ void fill_cols(float* cols,
                                          const float* __restrict__ x,
                                          const float* __restrict__ off,
                                          const float* __restrict__ mask,
                                          const Geom& G, int g, int r0,
                                          int r_end, int tile,
                                          const Activity& A) {
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
    if (r < r_end && (!kMasked || row_active(A, G, r))) {
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

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
dcn_forward_kernel(const float* __restrict__ x, const float* __restrict__ off,
                   const float* __restrict__ mask, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   Geom G, int tile, Activity A) {
  extern __shared__ float smem[];
  const int K = G.kh * G.kw;
  const int cg = G.Cin / G.dg;
  const int KC = K * cg;
  const int Cout = G.Cout;
  float* cols = smem;              // [tile][KC]
  float* wg = smem + tile * KC;    // [KC][Cout]
  const int rows = G.B * G.Ho * G.Wo;
  const int r0 = blockIdx.x * tile;
  const int tid = threadIdx.x;
  const int n_out = tile * Cout;

  float acc[kFwdAcc];
#pragma unroll
  for (int i = 0; i < kFwdAcc; ++i) acc[i] = 0.f;

  // block-uniform: every thread of the block takes the same branch
  bool any_active = true;
  if (kMasked) {
    int mine = 0;
    for (int p = tid; p < tile; p += kThreads) {
      mine |= (r0 + p < rows && row_active(A, G, r0 + p)) ? 1 : 0;
    }
    any_active = __syncthreads_or(mine) != 0;
  }

  for (int g = 0; any_active && g < G.dg; ++g) {
    fill_cols<kMasked>(cols, x, off, mask, G, g, r0, rows, tile, A);
    for (int e = tid; e < KC * Cout; e += kThreads) {
      const int j = e / Cout;
      const int o = e - j * Cout;
      const int k = j / cg;
      const int c = j - k * cg;
      wg[e] = w[((size_t)k * G.Cin + g * cg + c) * Cout + o];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFwdAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < n_out) {
        const int p = idx / Cout;
        const int o = idx - p * Cout;
        const float* cr = cols + p * KC;
        float a = acc[i];
        for (int j = 0; j < KC; ++j) a = fmaf(cr[j], wg[j * Cout + o], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kFwdAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < n_out) {
      const int p = idx / Cout;
      const int o = idx - p * Cout;
      const int r = r0 + p;
      if (r < rows) {
        const float b = bias != nullptr ? bias[o] : 0.f;
        out[(size_t)r * Cout + o] =
            (!kMasked || row_active(A, G, r)) ? acc[i] + b : 0.f + b;
      }
    }
  }
}

bool geom_ok(const Geom& G) {
  return G.dg >= 1 && G.Cin % G.dg == 0 && G.Cout >= 1 && G.kh >= 1 &&
         G.kw >= 1;
}

// Opts a kernel into more than the default 48 KB of dynamic shared memory.
template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Launches the forward body; returns cudaGetLastError() (0 on success).
// tile * Cout must not exceed kThreads * kFwdAcc. The masked body needs a
// bitmap whose n_tiles tiles of no_tile pixels cover Ho * Wo.
template <bool kMasked>
int launch_dcn_forward(const float* x, const float* off, const float* mask,
                       const float* w, const float* bias, float* out,
                       const Geom& G, int tile, const Activity& A,
                       void* stream) {
  if (!geom_ok(G) || tile < 1 || tile * G.Cout > kThreads * kFwdAcc) {
    return (int)cudaErrorInvalidValue;
  }
  if (kMasked && (A.am == nullptr || A.n_tiles < 1 || A.no_tile < 1 ||
                  (long long)A.n_tiles * A.no_tile < (long long)G.Ho * G.Wo)) {
    return (int)cudaErrorInvalidValue;
  }
  const int KC = G.kh * G.kw * (G.Cin / G.dg);
  const size_t smem = (size_t)(tile * KC + KC * G.Cout) * sizeof(float);
  cudaError_t err = allow_smem(dcn_forward_kernel<kMasked>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = G.B * G.Ho * G.Wo;
  dcn_forward_kernel<kMasked><<<(rows + tile - 1) / tile, kThreads, smem,
                                (cudaStream_t)stream>>>(x, off, mask, w, bias,
                                                        out, G, tile, A);
  return (int)cudaGetLastError();
}

}  // namespace
