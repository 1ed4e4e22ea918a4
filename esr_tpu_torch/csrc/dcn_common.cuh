// Shared device code of the DCNv2 kernels (f32, Hopper sm_90a): the
// bilinear sampling, the cp.async helpers, and the one forward body that
// both forward entry points launch (dcn_fwd_f32 in dcn_fwd.cu, the forward
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
// The forward body replaces the TPU kernels esr_tpu/ops/dcn_pallas.py:
// _dcn_fwd_kernel, _dcn_fwd_kernel_masked, _dcn_kernel and
// _dcn_kernel_masked (the four compute one function; see dcn_fwd.cu and
// dcn_train.cu). It is an implicit GEMM out[rows, Cout] = cols[rows, dg*K*Cg]
// @ W[dg*K*Cg, Cout] whose column matrix is gathered on the fly and never
// leaves shared memory.
//
// What bounds it on the H100: at the flagship (dg 8, K 9, Cg 8, Cout 64)
// the contraction is 2*rows*576*64 FLOP, 8.5 us at B=32 at the 67 TFLOP/s
// f32 rate, and the bytes are ~2 MB (0.6 us), so it is bound by operations;
// at B=1 (240 rows) both bounds are under a microsecond and what is left is
// latency: the gather's two dependent loads (offset, then corners), the
// FMA chain, the barriers, the launch. The earlier body spent two scalar
// shared loads per FMA and ran the 8 groups as 8 serial gather -> barrier
// -> FMA -> barrier phases, restaging all of W in every block.
//
// The design here:
//   - Register-blocked SIMT contraction, f32 FMAs (no TF32). A block owns
//     tm rows x tn out-channels; each thread a micro-tile of RM rows x 4
//     out-channels. The columns are stored K-major, cols[j][row], and W as
//     ws[j][o], so one column step is one shared load of RM rows
//     (LDS.64/128 or scalar) and one LDS.128 of W for 4*RM FMAs.
//   - Columns in tap-major order, c = k*Cin + channel, which is W's own row
//     order: a stage's slice of W is one contiguous block of rows, staged
//     with cp.async (16-byte copies when Cout % 4 == 0).
//   - A software pipeline over stages of a few columns each, double
//     buffered, one barrier per stage. Each thread owns one row of the
//     block (its output geometry computed once) and 2-4 items of 4
//     channels per stage. An item's offsets and mask are loaded two stages
//     ahead, its bilinear corners (float4) one stage ahead and issued
//     before the current stage's FMAs, and it is combined and stored after
//     them, so the gather's two dependent loads hide behind the FMAs.
//   - Out-channels split across blocks (grid.y) when the batch is small,
//     so each block stages only its tn columns of W and the card still
//     gets enough blocks. The launch configuration (tm, tn, RM) comes from
//     one chooser in esr_tpu_torch/ops/dcn_cuda.py (fwd_config).
//   - No split-K and no atomics: each output is a chain of FMA chains over
//     blocks of kFwdBlock columns in that fixed order from 0, then + bias,
//     whatever the configuration. So masked == dense bitwise on truthful
//     masks, a row of a batch equals the same image alone bitwise, and any
//     two configurations agree bitwise.
//   - Ragged shapes: tn is a multiple of 4; W's columns past Cout are
//     staged as zeros and their outputs not stored; W and the output move
//     as float4 only when Cout % 4 == 0 and the pointers are aligned, x
//     only when Cg % 4 == 0 and x is aligned (else 1-channel items).
//
// The masked body (kMasked = true) is the activity-predicated twin of
// _dcn_fwd_kernel_masked / _dcn_kernel_masked: an int32 bitmap
// am[B][n_tiles] marks which (image, output tile) pairs are active, output
// pixel n of an image lying in tile n / no_tile. Rows are flattened across
// images, so a block's rows may straddle images and tiles: the predicate is
// per row. An inactive row gathers nothing (x, offsets and mask are not
// read) and its output is selected as 0 + bias, whatever the FMAs give (a
// non-finite W would make them NaN); a block whose rows are all inactive
// skips staging and the FMAs. On an active row the masked body runs the
// dense body's arithmetic, so on a truthful mask (an inactive image is all
// zero) the two agree bitwise.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the most threads a block of any kernel here has
// The forward sums an output's columns in blocks of kFwdBlock (one FMA
// chain each, in column order) and the block sums in order: one chain over
// all K*Cin columns (4608 at basech 64) lost enough precision to put a
// basech-64 train step's gradients 1e-3 of their scale from the plain
// path's, against ~2e-4 between the plain path and f64. Fixed by the
// column index, not the stage, so every configuration gives the same bits.
constexpr int kFwdBlock = 32;

struct Geom {
  int B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil;
};

// The activity bitmap of the masked body (unused by the dense one).
struct Activity {
  const int* am;  // [B][n_tiles], nonzero = active
  int n_tiles;
  int no_tile;    // output pixels per tile
};

// The forward's launch configuration: tm rows x tn out-channels per block,
// rm rows x 4 out-channels per thread (the template RM).
struct FwdTile {
  int tm, tn, rm;
};

__device__ __forceinline__ bool row_active(const Activity& A, const Geom& G,
                                           int r) {
  const int npix = G.Ho * G.Wo;
  const int b = r / npix;
  return A.am[b * A.n_tiles + (r - b * npix) / A.no_tile] != 0;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Asynchronous global -> shared copies (sm_80+), completed by
// cp_async_wait_all before the barrier that publishes them.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// The forward's gather, one stage at a time. A thread owns one row
// (p = tid % tm) and kU column items of V channels per stage (quads
// slot + u * nslots, slot = tid / tm), so the row's geometry is computed
// once. An item goes through three steps, spread over the pipeline so that
// no stage waits on a dependent load: its offsets and mask are loaded two
// stages ahead (Pref), its corners one stage ahead (Corners, issued before
// the current stage's FMAs), and it is combined and stored after them.
struct Row {
  const float* x;     // the row's image
  const float* off;   // the row's offsets [dg][K][2]
  const float* mask;  // the row's mask [dg][K]
  int oh, ow;
  bool ok;            // inside the batch (and active, when masked)
};

struct Pref {
  float oy, ox, m;
};

template <int V>
struct Corners {
  float v[4][V];
  float cw[4];
  float m;
};

// The first column of item u of stage s (tap-major: c = k * Cin + channel).
__device__ __forceinline__ int item_col(int s, int js, int u, int slot,
                                        int nslots, int V) {
  return s * js + (slot + u * nslots) * V;
}

__device__ __forceinline__ void load_pref(Pref& P, const Row& R, const Geom& G,
                                          int col, int kct) {
  if (!R.ok || col >= kct) return;
  const int K = G.kh * G.kw;
  const int k = col / G.Cin;
  const int g = (col - k * G.Cin) / (G.Cin / G.dg);
  P.oy = R.off[2 * (g * K + k)];
  P.ox = R.off[2 * (g * K + k) + 1];
  P.m = R.mask[g * K + k];
}

// The bilinear corners of V channels at tap (ky, kx) of output pixel
// (oh, ow), in the reference's corner order (0,0), (0,1), (1,0), (1,1);
// src points at the first channel in its image. Zero weight and value
// outside the image (float compares: a NaN or huge offset never reaches an
// int cast).
template <int V>
__device__ __forceinline__ void sample_corners(Corners<V>& C, const Pref& P,
                                               const float* src, int oh,
                                               int ow, int ky, int kx,
                                               const Geom& G) {
  const float ys = (float)(oh * G.stride - G.pad + ky * G.dil) + P.oy;
  const float xs = (float)(ow * G.stride - G.pad + kx * G.dil) + P.ox;
  const float fy = floorf(ys);
  const float fx = floorf(xs);
  const float dy = ys - fy;
  const float dx = xs - fx;
  const float cw[4] = {(1.f - dy) * (1.f - dx), (1.f - dy) * dx,
                       dy * (1.f - dx), dy * dx};
  C.m = P.m;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float cy = fy + (float)(c >> 1);
    const float cx = fx + (float)(c & 1);
    const bool ok = cy >= 0.f && cy <= (float)(G.H - 1) && cx >= 0.f &&
                    cx <= (float)(G.W - 1);
    C.cw[c] = ok ? cw[c] : 0.f;
    if (ok) {
      const float* at = src + ((size_t)((int)cy * G.W + (int)cx)) * G.Cin;
      if constexpr (V == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(at));
        C.v[c][0] = q.x; C.v[c][1] = q.y; C.v[c][2] = q.z; C.v[c][3] = q.w;
      } else {
        C.v[c][0] = __ldg(at);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) C.v[c][i] = 0.f;
    }
  }
}

// The bilinear corners of one item of the forward's gather.
template <int V>
__device__ __forceinline__ void issue_corners(Corners<V>& C, const Pref& P,
                                              const Row& R, const Geom& G,
                                              int col, int kct) {
  if (!R.ok || col >= kct) return;
  const int k = col / G.Cin;
  const int ky = k / G.kw;
  sample_corners<V>(C, P, R.x + (col - k * G.Cin), R.oh, R.ow, ky,
                    k - ky * G.kw, G);
}

// cols[jj][p] = m * sum_corner w_corner x[corner] (zero for a row this
// block does not compute).
template <int V>
__device__ __forceinline__ void store_item(float* cols, const Corners<V>& C,
                                           const Row& R, int jj, int p, int tm,
                                           int col, int kct) {
  if (col >= kct) return;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float v = 0.f;
    if (R.ok) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v += C.v[c][i] * C.cw[c];
      v *= C.m;
    }
    cols[(size_t)(jj + i) * tm + p] = v;
  }
}

// W's rows s*js .. s*js+jn-1 (tap-major: row k*Cin + channel, as W is laid
// out) and columns n0 .. n0+tn-1 into ws[jj][o - n0] by cp.async; columns
// past Cout are zero. A thread keeps one 4-column chunk.
__device__ __forceinline__ void stage_w(float* __restrict__ ws,
                                        const float* __restrict__ w,
                                        const Geom& G, int row0, int jn,
                                        int n0, int tn, bool vec) {
  const int nv = tn / 4;
  const int o4 = (threadIdx.x % nv) * 4;
  const int o = n0 + o4;
  for (int jj = threadIdx.x / nv; jj < jn; jj += blockDim.x / nv) {
    const float* src = w + (size_t)(row0 + jj) * G.Cout + o;
    float* dst = ws + (size_t)jj * tn + o4;
    if (vec && o < G.Cout) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (o + i < G.Cout) {
          cp_async4(dst + i, src + i);
        } else {
          dst[i] = 0.f;
        }
      }
    }
  }
}

template <bool kMasked, int RM, int V>
__device__ __forceinline__ void forward_main(
    const float* __restrict__ x, const float* __restrict__ off,
    const float* __restrict__ mask, const float* __restrict__ w,
    const Geom& G, const FwdTile& T, const Activity& A, float* smem,
    float (&acc)[RM][4]) {
  float part[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int l = 0; l < 4; ++l) part[i][l] = 0.f;
  }
  // gather items per thread per stage: small micro-tiles (RM 1) run at
  // small batches, where the stage count sets the latency
  constexpr int kU = RM == 1 ? 4 : 2;
  const int tm = T.tm;
  const int tn = T.tn;
  const int nv = tn / 4;
  const int nslots = blockDim.x / tm;
  const int js = kU * V * nslots;              // columns per stage
  const int jsmax = kU * 4 * nslots;           // the buffers' size (V = 4)
  const int kct = G.kh * G.kw * G.Cin;         // columns in all
  const int n_stages = (kct + js - 1) / js;
  float* cols = smem;                          // [2][jsmax][tm]
  float* ws = smem + 2 * jsmax * tm;           // [2][jsmax][tn]
  const int npix = G.Ho * G.Wo;
  const int rows = G.B * npix;
  const int r0 = blockIdx.x * tm;
  const int n0 = blockIdx.y * tn;
  const bool vec_w = G.Cout % 4 == 0 && aligned16(w);

  const int p = threadIdx.x % tm;
  const int slot = threadIdx.x / tm;
  Row R;
  {
    const int r = r0 + p;
    const int b = r / npix;
    const int n = r - b * npix;
    R.oh = n / G.Wo;
    R.ow = n - R.oh * G.Wo;
    R.ok = r < rows && (!kMasked || row_active(A, G, r));
    R.x = x + (size_t)b * G.H * G.W * G.Cin;
    R.off = off + (size_t)r * G.dg * G.kh * G.kw * 2;
    R.mask = mask + (size_t)r * G.dg * G.kh * G.kw;
  }
  Pref P[kU];
  Corners<V> C[kU];

#pragma unroll
  for (int u = 0; u < kU; ++u) load_pref(P[u], R, G, item_col(0, js, u, slot, nslots, V), kct);
#pragma unroll
  for (int u = 0; u < kU; ++u) issue_corners<V>(C[u], P[u], R, G, item_col(0, js, u, slot, nslots, V), kct);
  if (n_stages > 1) {
#pragma unroll
    for (int u = 0; u < kU; ++u) load_pref(P[u], R, G, item_col(1, js, u, slot, nslots, V), kct);
  }
  stage_w(ws, w, G, 0, min(js, kct), n0, tn, vec_w);
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    store_item<V>(cols, C[u], R, (slot + u * nslots) * V, p, tm,
                  item_col(0, js, u, slot, nslots, V), kct);
  }
  cp_async_wait_all();
  __syncthreads();

  const int tx = threadIdx.x % nv;
  const int ty = threadIdx.x / nv;
  for (int s = 0; s < n_stages; ++s) {
    const int nb = (s + 1) & 1;
    if (s + 1 < n_stages) {
      // the next stage's corners, the stage after's offsets and the next
      // stage's W go out before this stage's FMAs
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        issue_corners<V>(C[u], P[u], R, G, item_col(s + 1, js, u, slot, nslots, V), kct);
      }
      if (s + 2 < n_stages) {
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          load_pref(P[u], R, G, item_col(s + 2, js, u, slot, nslots, V), kct);
        }
      }
      stage_w(ws + nb * jsmax * tn, w, G, (s + 1) * js,
              min(js, kct - (s + 1) * js), n0, tn, vec_w);
    }
    const int jn = min(js, kct - s * js);
    const float* cb = cols + (s & 1) * jsmax * tm + ty * RM;
    const float* wb = ws + (s & 1) * jsmax * tn + tx * 4;
#pragma unroll 4
    for (int j = 0; j < jn; ++j) {
      // a block of columns ends: its sum joins acc's chain of block sums
      if (j + s * js > 0 && (j + s * js) % kFwdBlock == 0) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            acc[i][l] += part[i][l];
            part[i][l] = 0.f;
          }
        }
      }
      float a[RM];
      if constexpr (RM == 4) {
        const float4 q = *reinterpret_cast<const float4*>(cb + j * tm);
        a[0] = q.x; a[1] = q.y; a[2] = q.z; a[3] = q.w;
      } else if constexpr (RM == 2) {
        const float2 q = *reinterpret_cast<const float2*>(cb + j * tm);
        a[0] = q.x; a[1] = q.y;
      } else {
        a[0] = cb[j * tm];
      }
      const float4 bw = *reinterpret_cast<const float4*>(wb + j * tn);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        part[i][0] = fmaf(a[i], bw.x, part[i][0]);
        part[i][1] = fmaf(a[i], bw.y, part[i][1]);
        part[i][2] = fmaf(a[i], bw.z, part[i][2]);
        part[i][3] = fmaf(a[i], bw.w, part[i][3]);
      }
    }
    if (s + 1 < n_stages) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        store_item<V>(cols + nb * jsmax * tm, C[u], R, (slot + u * nslots) * V, p,
                      tm, item_col(s + 1, js, u, slot, nslots, V), kct);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[i][l] += part[i][l];
  }
}

template <bool kMasked, int RM>
__global__ void __launch_bounds__(kThreads)
dcn_forward_kernel(const float* __restrict__ x, const float* __restrict__ off,
                   const float* __restrict__ mask, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   Geom G, FwdTile T, Activity A) {
  extern __shared__ __align__(16) float smem[];
  const int tm = T.tm;
  const int nv = T.tn / 4;
  const int rows = G.B * G.Ho * G.Wo;
  const int r0 = blockIdx.x * tm;
  const int n0 = blockIdx.y * T.tn;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[i][l] = 0.f;
  }

  // block-uniform: every thread of the block takes the same branch
  bool any_active = true;
  if (kMasked) {
    int mine = 0;
    for (int p = threadIdx.x; p < tm; p += blockDim.x) {
      mine |= (r0 + p < rows && row_active(A, G, r0 + p)) ? 1 : 0;
    }
    any_active = __syncthreads_or(mine) != 0;
  }
  if (any_active) {
    if ((G.Cin / G.dg) % 4 == 0 && aligned16(x)) {
      forward_main<kMasked, RM, 4>(x, off, mask, w, G, T, A, smem, acc);
    } else {
      forward_main<kMasked, RM, 1>(x, off, mask, w, G, T, A, smem, acc);
    }
  }

  const int tx = threadIdx.x % nv;
  const int ty = threadIdx.x / nv;
  const int o0 = n0 + tx * 4;
  const bool vec_out = G.Cout % 4 == 0 && aligned16(out) && o0 < G.Cout;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + ty * RM + i;
    if (r >= rows) continue;
    const bool live = !kMasked || row_active(A, G, r);
    float v[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int o = o0 + l;
      const float b = (bias != nullptr && o < G.Cout) ? bias[o] : 0.f;
      v[l] = live ? acc[i][l] + b : 0.f + b;
    }
    float* dst = out + (size_t)r * G.Cout + o0;
    if (vec_out) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        if (o0 + l < G.Cout) dst[l] = v[l];
      }
    }
  }
}

bool geom_ok(const Geom& G) {
  return G.dg >= 1 && G.Cin % G.dg == 0 && G.Cout >= 1 && G.kh >= 1 &&
         G.kw >= 1;
}

// Dynamic shared memory of the forward: two stages of columns and W, sized
// for 4-channel items. Mirrored by fwd_smem_bytes in ops/dcn_cuda.py.
size_t fwd_smem_bytes(const FwdTile& T) {
  const size_t nslots = T.tn / (4 * T.rm);
  const size_t jsmax = (T.rm == 1 ? 4 : 2) * 4 * nslots;
  return 2 * jsmax * (T.tm + T.tn) * sizeof(float);
}

bool fwd_tile_ok(const FwdTile& T) {
  if (T.rm != 1 && T.rm != 2 && T.rm != 4) return false;
  if (T.tm < 4 || T.tm % 4 != 0 || T.tn < 4 || T.tn % 4 != 0) return false;
  if ((T.tn / 4) % T.rm != 0) return false;  // whole gather slots per row
  const int threads = (T.tm / T.rm) * (T.tn / 4);
  return threads <= kThreads && fwd_smem_bytes(T) <= 232448;
}

// Opts a kernel into more than the default 48 KB of dynamic shared memory,
// once per kernel, device and size (the attribute call costs host time on
// every launch otherwise).
template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  struct Opted {
    const void* fn;
    int dev;
    size_t bytes;
  };
  static Opted opted[64];
  static int n_opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_opted; ++i) {
    if (opted[i].fn == fn && opted[i].dev == dev && opted[i].bytes >= bytes) {
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && n_opted < 64) opted[n_opted++] = Opted{fn, dev, bytes};
  return err;
}

template <bool kMasked, int RM>
int launch_forward_rm(const float* x, const float* off, const float* mask,
                      const float* w, const float* bias, float* out,
                      const Geom& G, const FwdTile& T, const Activity& A,
                      void* stream) {
  const size_t smem = fwd_smem_bytes(T);
  cudaError_t err = allow_smem(dcn_forward_kernel<kMasked, RM>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = G.B * G.Ho * G.Wo;
  const dim3 grid((rows + T.tm - 1) / T.tm, (G.Cout + T.tn - 1) / T.tn);
  const int threads = (T.tm / RM) * (T.tn / 4);
  dcn_forward_kernel<kMasked, RM><<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, off, mask, w, bias, out, G, T, A);
  return (int)cudaGetLastError();
}

// Launches the forward body; returns cudaGetLastError() (0 on success).
// The masked body needs a bitmap whose n_tiles tiles of no_tile pixels
// cover Ho * Wo.
template <bool kMasked>
int launch_dcn_forward(const float* x, const float* off, const float* mask,
                       const float* w, const float* bias, float* out,
                       const Geom& G, const FwdTile& T, const Activity& A,
                       void* stream) {
  if (!geom_ok(G) || !fwd_tile_ok(T)) return (int)cudaErrorInvalidValue;
  if (kMasked && (A.am == nullptr || A.n_tiles < 1 || A.no_tile < 1 ||
                  (long long)A.n_tiles * A.no_tile < (long long)G.Ho * G.Wo)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (T.rm) {
    case 4:
      return launch_forward_rm<kMasked, 4>(x, off, mask, w, bias, out, G, T, A, stream);
    case 2:
      return launch_forward_rm<kMasked, 2>(x, off, mask, w, bias, out, G, T, A, stream);
    default:
      return launch_forward_rm<kMasked, 1>(x, off, mask, w, bias, out, G, T, A, stream);
  }
}

}  // namespace
