// The int8 post-training-quantization (PTQ) rung's two kernels, for Hopper
// (sm_90a): the dynamic per-tensor activation quantization and the int8
// convolution with an int32 accumulator and a fused dequantizing epilogue.
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
//   - acc = sum q_x * q_w in int32 (|acc| <= K * 127^2, far below 2^31);
//   - out = float(acc) * (s_x * s_w[n]), then + bias[n]: two roundings in
//     that order, with no FMA contraction (__fmul_rn / __fadd_rn).
// So the kernels are bitwise equal to their plain versions
// (esr_tpu_torch/ops/int8_cuda.py), which the CPU runs.
//
// quantize_per_tensor: an amax pass (grid-stride max of |x|, warp and block
// reductions, one integer atomicMax of the float bits per block: a maximum
// does not depend on order), then one pass that reads x in its NCHW layout
// (consecutive threads on consecutive pixels of one channel quad) and writes
// q in the layout the convolution reads: NHWC with the channels padded to a
// multiple of 4 with zeros, one 32-bit store per (pixel, 4 channels). Bound
// by bytes: 4 bytes read twice and 1 written per element.
//
// int8_conv: an implicit GEMM, M = B*Ho*Wo rows, N = Cout, K = kh*kw*Cp
// (tap-major, the padded channels minor) padded with zeros to the MMA's 32.
// Each warp owns 16 rows x 8*NT out-channels and runs mma.sync.m16n8k32
// (s8 x s8 -> s32) on fragments loaded straight from global memory (L1/L2):
// a 32-bit load of A is 4 consecutive channels of one input pixel (zero
// outside the image), a 32-bit load of B 4 consecutive k of one out-channel
// of the packed weight [Np][Kp]. Four warps stack along M (64 rows a block);
// the grid's y covers Np / (8*NT). The epilogue dequantizes and writes NCHW
// f32. A simple kernel that is right: no shared-memory staging, no wgmma or
// TMA yet. At the flagship the convs are small (K <= 1728, M <= 184320);
// times against the int8 tensor-core and memory bounds are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kConvThreads = 128;  // 4 warps along M
constexpr int kConvRows = 64;

__device__ __forceinline__ float max_nan(float a, float v) {
  return (v > a || v != v) ? v : a;  // a NaN, once met, stays (as jnp.max)
}

__global__ void __launch_bounds__(kThreads)
amax_kernel(const float* __restrict__ x, long long n, unsigned* __restrict__ word) {
  __shared__ float red[kThreads / 32];
  float a = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    a = max_nan(a, fabsf(x[i]));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) a = max_nan(a, __shfl_xor_sync(0xffffffffu, a, d));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) a = max_nan(a, red[i]);
    // non-negative floats (and NaN above +inf) order as their bits
    atomicMax(word, __float_as_uint(a));
  }
}

__device__ __forceinline__ float scale_of(unsigned word) {
  const float amax = __uint_as_float(word);
  // jnp.maximum(amax, 1e-12) / 127: NaN propagates, as in the reference
  return __fdiv_rn(amax != amax ? amax : fmaxf(amax, 1e-12f), 127.0f);
}

__device__ __forceinline__ int quantize_one(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));  // round half to even
  return (int)fminf(fmaxf(r, -127.f), 127.f);
}

// x NCHW [B, C, HW] f32 -> q NHWC [B, HW, Cp] int8, the padded channels 0;
// scale_out[0] = the scale.
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int B, int C, int HW, int Cp,
                const unsigned* __restrict__ word, int8_t* __restrict__ q,
                float* __restrict__ scale_out) {
  const float scale = scale_of(*word);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[0] = scale;
  const int nq = Cp / 4;
  const long long n = (long long)B * nq * HW;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int pix = (int)(i % HW);
    const long long bq = i / HW;
    const int quad = (int)(bq % nq);
    const int b = (int)(bq / nq);
    unsigned packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * quad + j;
      if (c < C) {
        const int v = quantize_one(x[((size_t)b * C + c) * HW + pix], scale);
        packed |= (unsigned)(v & 0xff) << (8 * j);
      }
    }
    *reinterpret_cast<unsigned*>(q + ((size_t)b * HW + pix) * Cp + 4 * quad) = packed;
  }
}

struct ConvGeom {
  int B, H, W, Cp, Ho, Wo, N, Np, Kp, kh, kw, stride, pad, dil;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments (PTX ISA, mma.m16n8k32 .s8): lane = 4 * g + t. A: reg 0 row g,
// k 4t..4t+3; reg 1 row g + 8, the same k; regs 2 and 3 the same rows at
// k + 16. B: reg 0 k 4t..4t+3 of column g, reg 1 k + 16. C: regs 0, 1 row
// g, columns 2t, 2t + 1; regs 2, 3 row g + 8.
template <int NT>
__global__ void __launch_bounds__(kConvThreads)
int8_conv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, float* __restrict__ out, ConvGeom G) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int npix = G.Ho * G.Wo;
  const int M = G.B * npix;
  const int taps = G.kh * G.kw;
  const int m0 = blockIdx.x * kConvRows + warp * 16;
  const int n0 = blockIdx.y * (8 * NT);

  // the thread's two rows, m0 + g and m0 + g + 8
  bool rok[2];
  int rimg[2], riy[2], rix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
    rok[h] = m < M;
    const int mm = rok[h] ? m : 0;
    const int b = mm / npix;
    const int r = mm - b * npix;
    const int oy = r / G.Wo;
    rimg[h] = b;
    riy[h] = oy * G.stride - G.pad;
    rix[h] = (r - oy * G.Wo) * G.stride - G.pad;
  }

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  }

  for (int k0 = 0; k0 < G.Kp; k0 += 32) {
    unsigned a[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kq = k0 + 16 * half + 4 * t;
      const int tap = kq / G.Cp;
      const int c = kq - tap * G.Cp;
      const int ky = tap / G.kw;
      const int kx = tap - ky * G.kw;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned v = 0;
        const int iy = riy[h] + ky * G.dil;
        const int ix = rix[h] + kx * G.dil;
        if (rok[h] && tap < taps && iy >= 0 && iy < G.H && ix >= 0 && ix < G.W) {
          v = __ldg(reinterpret_cast<const unsigned*>(
              xq + (((size_t)rimg[h] * G.H + iy) * G.W + ix) * G.Cp + c));
        }
        a[2 * half + h] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int8_t* wr = wq + (size_t)(n0 + 8 * j + g) * G.Kp + k0 + 4 * t;
      const unsigned b0 = __ldg(reinterpret_cast<const unsigned*>(wr));
      const unsigned b1 = __ldg(reinterpret_cast<const unsigned*>(wr + 16));
      mma_s8(acc[j], a, b0, b1);
    }
  }

  const float s_x = *sx;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int n = n0 + 8 * j + 2 * t + (e & 1);
      if (!rok[h] || n >= G.N) continue;
      const int m = m0 + g + 8 * h;
      const int r = m - rimg[h] * npix;
      float v = __fmul_rn(__int2float_rn(acc[j][e]), __fmul_rn(s_x, sw[n]));
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      out[((size_t)rimg[h] * G.N + n) * npix + r] = v;
    }
  }
}

template <int NT>
int launch_conv(const int8_t* xq, const int8_t* wq, const float* sx, const float* sw,
                const float* bias, float* out, const ConvGeom& G, cudaStream_t st) {
  const int M = G.B * G.Ho * G.Wo;
  const dim3 grid((M + kConvRows - 1) / kConvRows, G.Np / (8 * NT));
  int8_conv_kernel<NT><<<grid, kConvThreads, 0, st>>>(xq, wq, sx, sw, bias, out, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes); each returns cudaGetLastError()
// after its launches: 0 on success, cudaErrorInvalidValue for arguments the
// kernels do not take. The caller allocates every output.

// x NCHW [B, C, H*W] f32 (contiguous) -> q NHWC [B, H*W, Cp] int8 and
// scale [1] f32. word is one 32-bit scratch word; this entry zeroes it.
extern "C" int quantize_per_tensor_f32(const float* x, int B, int C, int HW, int Cp,
                                       int8_t* q, float* scale, unsigned* word,
                                       void* stream) {
  if (B < 1 || C < 1 || HW < 1 || Cp < C || Cp % 4 != 0 ||
      (long long)B * HW * Cp >= (1LL << 31) || (long long)B * C * HW >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(word, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * C * HW;
  const int blocks = (int)std::max(1LL, std::min(1056LL, (n + kThreads - 1) / kThreads));
  amax_kernel<<<blocks, kThreads, 0, st>>>(x, n, word);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nq = (long long)B * (Cp / 4) * HW;
  const int qblocks = (int)std::max(1LL, std::min(4096LL, (nq + kThreads - 1) / kThreads));
  quantize_kernel<<<qblocks, kThreads, 0, st>>>(x, B, C, HW, Cp, word, q, scale);
  return (int)cudaGetLastError();
}

// xq NHWC [B, H, W, Cp] int8, wq [Np][Kp] int8 (row n: k = tap * Cp + c,
// zero-padded; rows N..Np zero), sx [1], sw [N], bias [N] or null ->
// out NCHW [B, N, Ho, Wo] f32. nt: out-channel tiles of 8 per warp (1, 2,
// 4 or 8), Np a multiple of 8 * nt, Kp of 32, Kp >= kh * kw * Cp.
extern "C" int int8_conv_f32(const int8_t* xq, const int8_t* wq, const float* sx,
                             const float* sw, const float* bias, float* out, int B,
                             int H, int W, int Cp, int Ho, int Wo, int N, int Np,
                             int Kp, int kh, int kw, int stride, int pad, int dil,
                             int nt, void* stream) {
  const ConvGeom G{B, H, W, Cp, Ho, Wo, N, Np, Kp, kh, kw, stride, pad, dil};
  if (B < 1 || H < 1 || W < 1 || Ho < 1 || Wo < 1 || N < 1 || Cp < 4 || Cp % 4 != 0 ||
      kh < 1 || kw < 1 || stride < 1 || pad < 0 || dil < 1 || Kp % 32 != 0 ||
      Kp < kh * kw * Cp || (nt != 1 && nt != 2 && nt != 4 && nt != 8) ||
      Np % (8 * nt) != 0 || Np < N || (long long)B * Ho * Wo >= (1LL << 31) ||
      (long long)B * N * Ho * Wo >= (1LL << 31) || (long long)B * H * W * Cp >= (1LL << 31) ||
      (long long)Np * Kp >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (nt) {
    case 1: return launch_conv<1>(xq, wq, sx, sw, bias, out, G, st);
    case 2: return launch_conv<2>(xq, wq, sx, sw, bias, out, G, st);
    case 4: return launch_conv<4>(xq, wq, sx, sw, bias, out, G, st);
    default: return launch_conv<8>(xq, wq, sx, sw, bias, out, G, st);
  }
}
