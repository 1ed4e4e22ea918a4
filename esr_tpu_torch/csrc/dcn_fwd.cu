// Modulated deformable convolution (DCNv2) forward, f32, for Hopper (sm_90a):
// the forward direction (inference, validation, the streaming engine and
// serving; no gradient).
//
// Replaces the TPU kernel esr_tpu/ops/dcn_pallas.py:_dcn_fwd_kernel (tile
// body _dcn_fwd_tile_acc), reached through deform_conv2d_pallas_fwd, and,
// through dcn_fwd_masked_f32, its activity-predicated twin
// _dcn_fwd_kernel_masked (the same body with kMasked = true). It
// computes the same function, not the TPU's formulation: the Pallas kernel
// recasts the bilinear gather as one-hot matrix products because a per-lane
// scalar gather does not map to the TPU's vector units. On the GPU threads
// gather directly into shared memory.
//
// The body is dcn_forward_kernel in dcn_common.cuh, shared with the train
// direction's forward (dcn_train.cu): both compute the same output, so they
// run the same code and differ only in their entry point and launch count.
// Layouts, what bounds the body and its design (register-blocked SIMT
// contraction, cp.async-staged W, a software-pipelined gather over
// double-buffered stages, out-channels split across blocks at small
// batches) are described there.
//
// Bound at the flagship shape (x [1,12,20,64], dg 8, K 9, Cout 64): the
// contraction is 2*240*576*64 = 17.7 MFLOP, 0.26 us at the H100's 67 TFLOP/s
// f32 rate; the inputs and output are ~0.48 MB, 0.14 us at 3.35 TB/s. Both
// are far below a launch (a few us): at B=1 and B=4 (the engine's lanes)
// the body is bound by latency, so the chooser in ops/dcn_cuda.py splits
// the out-channels over many small blocks. Measured times are in PERF.md
// (chip_smoke.py).

#include "dcn_common.cuh"

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success, cudaErrorInvalidValue for a configuration the
// body does not take. (tm, tn, rm) is the launch configuration of
// FwdTile; the caller picks it (ops/dcn_cuda.py:fwd_config).
extern "C" int dcn_fwd_f32(const float* x, const float* off, const float* mask,
                           const float* w, const float* bias, float* out,
                           int B, int H, int W, int Cin, int Ho, int Wo,
                           int Cout, int dg, int kh, int kw, int stride,
                           int pad, int dil, int tm, int tn, int rm,
                           void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  return launch_dcn_forward<false>(x, off, mask, w, bias, out, G,
                                   FwdTile{tm, tn, rm}, Activity{}, stream);
}

// The activity-predicated forward (replaces _dcn_fwd_kernel_masked): am is
// the int32 bitmap [B][n_tiles] of (image, output tile) activity, output
// pixel n of an image in tile n / no_tile.
extern "C" int dcn_fwd_masked_f32(const float* x, const float* off,
                                  const float* mask, const float* w,
                                  const float* bias, float* out, const int* am,
                                  int B, int H, int W, int Cin, int Ho, int Wo,
                                  int Cout, int dg, int kh, int kw, int stride,
                                  int pad, int dil, int tm, int tn, int rm,
                                  int n_tiles, int no_tile,
                                  void* stream) {
  const Geom G{B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride, pad, dil};
  return launch_dcn_forward<true>(x, off, mask, w, bias, out, G,
                                  FwdTile{tm, tn, rm},
                                  Activity{am, n_tiles, no_tile}, stream);
}
