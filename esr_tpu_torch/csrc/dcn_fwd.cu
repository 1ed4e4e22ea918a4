// Modulated deformable convolution (DCNv2) forward, f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel esr_tpu/ops/dcn_pallas.py:_dcn_fwd_kernel (tile
// body _dcn_fwd_tile_acc), reached through deform_conv2d_pallas_fwd. It
// computes the same function, not the TPU's formulation: the Pallas kernel
// recasts the bilinear gather as one-hot matrix products because a per-lane
// scalar gather does not map to the TPU's vector units. On the GPU each
// thread gathers directly.
//
// Layouts (the reference's, channel-last):
//   x       [B, H, W, Cin]
//   offsets [B, Ho, Wo, dg, K, 2]   (dy, dx) per output pixel, group, tap
//   mask    [B, Ho, Wo, dg, K]      already sigmoid'd
//   weight  [kh, kw, Cin, Cout]     HWIO
//   bias    [Cout] or null
//   out     [B, Ho, Wo, Cout]
//
// Design: one block per (image, tile of TP output pixels), 256 threads.
// For each deformable group g:
//   1. sample: each (pixel, tap) pair computes its four corner indices and
//      bilinear weights (zero outside the image, the boundary rule of
//      esr_tpu/ops/dcn.py:_bilinear_gather), reads the Cg contiguous
//      channels of each corner from NHWC x, multiplies by the mask and
//      writes the column tile cols[TP][K*Cg] to shared memory;
//   2. stage W[g] = weight[:, :, g*Cg:(g+1)*Cg, :] as [K*Cg][Cout] in shared
//      memory;
//   3. every thread accumulates its (pixel, out-channel) outputs over the
//      K*Cg columns with plain f32 FMAs in registers (no TF32).
// The bias is added in the epilogue. The column tensor never goes to
// global memory.
//
// Bound at the flagship shape (x [1,12,20,64], dg 8, K 9, Cout 64): the
// contraction is 2*240*576*64 = 17.7 MFLOP, 0.26 us at the H100's 67 TFLOP/s
// f32 rate; the inputs and output are ~0.48 MB, 0.14 us at 3.35 TB/s. Both
// are far below a launch (a few us). The measured time (PERF.md, from
// chip_smoke.py) is ~50 us at B=1 and about the same at B=4: ~10x a launch
// and ~200x the bound, so this design, not the launch, sets it. Not yet
// measured which part; the candidates, all read off the code:
//   - at B=1 the grid is 240 / tile_p(4) = 60 blocks on 132 SMs;
//   - in the sampling phase only tile_p*K = 36 of the 256 threads work, each
//     with 4*Cg = 32 dependent global gathers per group, and the 8 groups
//     run one after another behind barriers;
//   - W[g] is restaged from global memory for every group of every block.
// wgmma/TMA are left for a later change.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAccPerThread = 8;

__global__ void __launch_bounds__(kThreads)
dcn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ off,
               const float* __restrict__ mask, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int H, int W, int Cin, int Ho, int Wo, int Cout, int dg,
               int kh, int kw, int stride, int pad, int dil, int tile_p) {
  extern __shared__ float smem[];
  const int K = kh * kw;
  const int cg = Cin / dg;
  const int KC = K * cg;
  float* cols = smem;               // [tile_p][KC]
  float* wg = smem + tile_p * KC;   // [KC][Cout]

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * tile_p;
  const int npix = Ho * Wo;
  const int tid = threadIdx.x;
  const int n_out = tile_p * Cout;
  const float* xb = x + (size_t)b * H * W * Cin;

  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  for (int g = 0; g < dg; ++g) {
    // 1. the column tile of group g
    for (int pk = tid; pk < tile_p * K; pk += kThreads) {
      const int p = pk / K;
      const int k = pk - p * K;
      const int n = n0 + p;
      float* dst = cols + p * KC + k * cg;
      if (n >= npix) {
        for (int cc = 0; cc < cg; ++cc) dst[cc] = 0.f;
        continue;
      }
      const int oh = n / Wo;
      const int ow = n - oh * Wo;
      const int ky = k / kw;
      const int kx = k - ky * kw;
      const size_t q = ((size_t)(b * npix + n) * dg + g) * K + k;
      const float ys = (float)(oh * stride - pad + ky * dil) + off[2 * q];
      const float xs = (float)(ow * stride - pad + kx * dil) + off[2 * q + 1];
      const float m = mask[q];
      const float fy = floorf(ys);
      const float fx = floorf(xs);
      const float dy = ys - fy;
      const float dx = xs - fx;
      // corner order (0,0), (0,1), (1,0), (1,1), as in the reference
      const float cw[4] = {(1.f - dy) * (1.f - dx), (1.f - dy) * dx,
                           dy * (1.f - dx), dy * dx};
      const float* src[4];
      bool ok[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float cy = fy + (float)(c >> 1);
        const float cx = fx + (float)(c & 1);
        // float compares: a NaN or huge offset never reaches an int cast
        ok[c] = cy >= 0.f && cy <= (float)(H - 1) && cx >= 0.f &&
                cx <= (float)(W - 1);
        src[c] = ok[c] ? xb + ((size_t)(int)cy * W + (int)cx) * Cin + g * cg
                       : xb;
      }
      for (int cc = 0; cc < cg; ++cc) {
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (ok[c]) v += src[c][cc] * cw[c];
        }
        dst[cc] = v * m;
      }
    }
    // 2. W[g] as [K*Cg][Cout]
    for (int e = tid; e < KC * Cout; e += kThreads) {
      const int j = e / Cout;
      const int o = e - j * Cout;
      const int k = j / cg;
      const int cc = j - k * cg;
      wg[e] = w[((size_t)k * Cin + g * cg + cc) * Cout + o];
    }
    __syncthreads();
    // 3. acc[p, o] += sum_j cols[p, j] * W[g][j, o]
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
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
  for (int i = 0; i < kAccPerThread; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < n_out) {
      const int p = idx / Cout;
      const int o = idx - p * Cout;
      const int n = n0 + p;
      if (n < npix) {
        out[((size_t)b * npix + n) * Cout + o] =
            acc[i] + (bias != nullptr ? bias[o] : 0.f);
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success. tile_p * Cout must not exceed
// kThreads * kAccPerThread; the caller sizes tile_p and the shared memory.
extern "C" int dcn_fwd_f32(const float* x, const float* off, const float* mask,
                           const float* w, const float* bias, float* out,
                           int B, int H, int W, int Cin, int Ho, int Wo,
                           int Cout, int dg, int kh, int kw, int stride,
                           int pad, int dil, int tile_p, void* stream) {
  if (tile_p < 1 || tile_p * Cout > kThreads * kAccPerThread || dg < 1 ||
      Cin % dg != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int KC = kh * kw * (Cin / dg);
  const size_t smem = (size_t)(tile_p * KC + KC * Cout) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dcn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int npix = Ho * Wo;
  dim3 grid((npix + tile_p - 1) / tile_p, B);
  dcn_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, off, mask, w, bias, out, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride,
      pad, dil, tile_p);
  return (int)cudaGetLastError();
}

// Launch geometry constants, so the Python wrapper sizes tiles from the
// library it actually loaded.
extern "C" int dcn_fwd_threads(void) { return kThreads; }
extern "C" int dcn_fwd_acc_per_thread(void) { return kAccPerThread; }
