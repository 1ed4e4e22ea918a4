// Modulated deformable convolution (DCNv2) forward, f32, for Hopper (sm_90a):
// the forward direction (inference and validation, no gradient).
//
// Replaces the TPU kernel esr_tpu/ops/dcn_pallas.py:_dcn_fwd_kernel (tile
// body _dcn_fwd_tile_acc), reached through deform_conv2d_pallas_fwd, and,
// through dcn_fwd_masked_f32, its activity-predicated twin
// _dcn_fwd_kernel_masked (the same body with kMasked = true). It
// computes the same function, not the TPU's formulation: the Pallas kernel
// recasts the bilinear gather as one-hot matrix products because a per-lane
// scalar gather does not map to the TPU's vector units. On the GPU each
// thread gathers directly.
//
// The body is dcn_forward_kernel in dcn_common.cuh, shared with the train
// direction's forward (dcn_train.cu): both compute the same output, so they
// run the same code and differ only in their entry point and launch count.
// Layouts and the design are described there; the caller (the Python
// wrapper) picks the rows per block from the batch.
//
// Bound at the flagship shape (x [1,12,20,64], dg 8, K 9, Cout 64): the
// contraction is 2*240*576*64 = 17.7 MFLOP, 0.26 us at the H100's 67 TFLOP/s
// f32 rate; the inputs and output are ~0.48 MB, 0.14 us at 3.35 TB/s. Both
// are far below a launch (a few us). Measured times are in PERF.md
// (chip_smoke.py).

#include "dcn_common.cuh"

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success. tile (rows per block) * Cout must not exceed
// kThreads * kFwdAcc; the caller sizes tile and the shared memory.
extern "C" int dcn_fwd_f32(const float* x, const float* off, const float* mask,
                           const float* w, const float* bias, float* out,
                           int B, int H, int W, int Cin, int Ho, int Wo,
                           int Cout, int dg, int kh, int kw, int stride,
                           int pad, int dil, int tile, void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  return launch_dcn_forward<false>(x, off, mask, w, bias, out, G, tile,
                                   Activity{}, stream);
}

// The activity-predicated forward (replaces _dcn_fwd_kernel_masked): am is
// the int32 bitmap [B][n_tiles] of (image, output tile) activity, output
// pixel n of an image in tile n / no_tile.
extern "C" int dcn_fwd_masked_f32(const float* x, const float* off,
                                  const float* mask, const float* w,
                                  const float* bias, float* out, const int* am,
                                  int B, int H, int W, int Cin, int Ho, int Wo,
                                  int Cout, int dg, int kh, int kw, int stride,
                                  int pad, int dil, int tile, int n_tiles,
                                  int no_tile, void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  return launch_dcn_forward<true>(x, off, mask, w, bias, out, G, tile,
                                  Activity{am, n_tiles, no_tile}, stream);
}

// Launch geometry constants, so the Python wrapper sizes tiles from the
// library it actually loaded.
extern "C" int dcn_fwd_threads(void) { return kThreads; }
extern "C" int dcn_fwd_acc_per_thread(void) { return kFwdAcc; }
