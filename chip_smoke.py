#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``esr_tpu_torch``) runs on the
card: builds the DCN and int8 kernels from ``esr_tpu_torch/csrc``, holds
each against its plain PyTorch version, drives sequential inference at
f32, bf16 and int8, the streaming engine and serving, and then training at
the flagship width.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``), the device
   count;
2. build: ``nvcc`` of ``dcn_fwd.cu``, ``dcn_train.cu`` and
   ``int8_conv.cu``, started together; their times and ``-Xptxas -v`` lines (a register spill in any
   instantiation fails); ``g++`` of the native host kernels
   (``host_kernels.cpp``), which must build;
3. kernel, forward: ``dcn_fwd`` against the plain ``deform_conv2d`` at the
   flagship shape (B=1 as in evaluation, B=4, B=8 as in the trainer's
   validation, B=32 as in training), at the 4x recipe's 24x40 bottleneck
   at its validation batch 8, and over an odd-size / group / stride /
   dilation / large-offset / Cg 16-Cout 6 matrix, within 1e-3 * max(|ref|,
   1); CUDA-event times of both (the kernel through its wrapper, which calls
   the kernel's ``torch.library`` op, and its C entry point) next to the
   roofline bound; at B=1 and B=32 a sweep over
   the launch chooser's candidates (``dcn_cuda.fwd_config``), each bitwise
   equal to the picked one; every image of a B=4 and a B=32 call bitwise
   equal to the same image alone at B=1;
4. kernel, train direction: ``dcn_train_fwd`` against ``deform_conv2d``,
   ``dcn_bwd`` (gx, goffsets, gmask) and ``dcn_wgrad`` (gW) against
   ``deform_conv2d_backward``, at the flagship training shape (B=32), B=1,
   the bottlenecks of basech 16, 32, 48 and 64 at B=32 (Cin = Cout = 128 to
   512, Cg 16 to 64) and of basech 128 at B=4 (Cin = Cout = 1024, Cg 128;
   Cg 48 and more take ``dcn_bwd``'s wide kernel), the 4x recipe's 24x40
   bottleneck at its batch 8, a 64x64 image of Cg 32 /
   Cout 64 whose slices do not fit shared memory (``dcn_bwd``'s global-red
   path) and the same matrix, each cotangent within 1e-3 * max(|ref|, 1);
   at the seven timed shapes every output twice, each bitwise equal run to
   run or fail (``gx`` is summed in 64-bit fixed point); wrapper and
   entry-point times and bounds, ``dcn_bwd``'s beside PR 6's (float
   atomics);
5. autograd: a loss through the model's DCN (``dcn_cuda.dcn``) on the card
   gives gradients for x, offsets, mask, weight and bias that match the
   plain path, through the kernels;
6. inference slice: ``InferenceRunner.run_recording`` at basech 8, seqn 3,
   scale 2, down16 -> down8 (90x160 HR grid), window 2048/1024, L 9, on a
   seeded 720x1280 synthetic recording with seeded random weights brought
   in through the flax weight bridge (non-zero offset/mask conv). The DCN
   launch count must be exactly 2 ``dcn_fwd`` per window, and every
   window's output and states must be finite and match the same model with
   ``dcn_impl='plain'`` within 1e-3 * max(|ref|, 1). Then the same weights
   saved as a port checkpoint (the exporter's format) and evaluated through
   ``run_inference`` (what ``python -m esr_tpu_torch.infer --save_images
   --no_engine`` calls; the recording stays in memory, as this machine has
   no h5py): metrics within 1e-5 of the run's, 6 PNG views per window in
   the reference's tree, each decoded, window 0's count views equal to
   their renders;
7. training: ``esr_tpu_torch.training.trainer.Trainer`` from
   ``configs/train_esr_2x.yml`` as written (batch 32, tensorboard and vis
   on), with overrides only for the run's length and paths (iterations 4,
   valid_step 2, save_period 2), fed in-memory synthetic 720x1280
   recordings. Its ``k_steps: 8`` groups the epoch's 4 batches into one
   group: validated and saved once, after iteration 3. The writer's JSONL records (every iteration's losses,
   ``steps_per_sec``, the learning rate, the validation stamp, 5 images per
   vis step) must be there. Each train step must launch ``dcn_train_fwd``,
   ``dcn_bwd`` and ``dcn_wgrad`` 14 times each (2 per window x 7 windows)
   and nothing else; validation only ``dcn_fwd``, 2 per window; losses
   and grad norms finite; a committed checkpoint that loads and runs. The
   flagship sets ``async_checkpoint: true``: that checkpoint was committed
   on the ``ckpt-commit`` writer, and it must carry the ``digest.json`` and
   ``meta.json`` of a sync save of the same state at the same iteration
   and restore bitwise the same parameters and optimizer state; then the
   ms a save blocks the loop, sync against async, in turns (sync, async,
   async, sync), beside the async commit's ms on the writer.
   Then one validation pass (batch 8) on the kernel path and on the plain
   path, and one train step from the same params and batch on both: the
   validation losses, the per-window losses and every parameter's grad
   within 1e-3 of their own scale (max |plain|). Step time, batch-build
   time and a ``torch.profiler`` breakdown of one step are printed. The B=32
   batch build of the trainer's loader with the native host kernels and
   with numpy, at ``num_workers`` 0, 2 and 4 (the native route must take
   every encoder call; every first batch bitwise the same). One B=32 step
   with ``trainer;device_rasterize=true``: its count images bitwise the
   host's, 14/14/14 launches, its loss within 1e-6 relative of the host
   step's from the same weights. C2: two B=32 steps of the trainer's step
   (BPTT, backward, Adam-amsgrad) from the same params, optimizer state
   and batch give bitwise-equal losses, grads and updated params, or fail.
   Last, one B=32 step at basech 16 and one
   B=4 step at basech 64 (``model;args;basech=...``, seeded params, the
   same batch; basech 64 runs ``dcn_bwd``'s wide kernel): 14 launches of
   each train kernel, losses and grads within 1e-3 of their scale of the
   plain path's, their step times; at basech 64 both paths' grads against
   the plain path in f64, printed.
7c. the 4x recipe: ``Trainer`` from ``configs/train_esr_4x.yml`` as
   written (batch 8, vis, tensorboard, async checkpoint), overriding only
   the run's length and paths (3 iterations, a validation after the
   third), on in-memory 720x1280 recordings with a down4 GT stream: 14
   launches of each train kernel a step at the 24x40 bottleneck, the
   validation only ``dcn_fwd``, a committed final checkpoint; one step's
   losses and grads within 1e-3 of their scale of the plain path's; the
   step's time and device busy time beside each kernel's time and bound
   at that shape (from phases 3 and 4).
8d. the second shipped recipe: ``Trainer`` from
   ``configs/train_srunet_2x.yml`` as written (``SRUNetRecurrentSeq``,
   f32, batch 8 on the 90x160 grid), overriding only the run's length and
   paths: 3 steps and a validation, finite losses, a committed checkpoint
   that reloads bitwise; two steps from one state bitwise (C2); one
   full-width window at B=1 on the card against the CPU (the output within
   1e-3 * max(|ref|, 1), every gradient within 1e-3 of its own scale; the
   numerics flags, the host's CPU and threads, the card's free memory and
   each side's distance from the CPU in f64 printed on every call); a
   step's time, device busy (the union of the profiler's kernel
   intervals), idle share and peak memory. Then ``k_steps: 8`` on 17
   batches (two full groups, the second a graph replay, and a tail)
   bitwise the ``k_steps: 1`` run (losses, 38 parameters, Adam's moments),
   a group captured against eager and the graph's pool; then the
   checkpoint through ``run_inference`` by the harness and by the engine
   (lanes 4 x chunk 8) over 5 recordings (finite, the engine within 1e-4
   of the harness), the engine's graphed chunk bitwise the eager one,
   windows/s and the harness's per-window p50. No hand-written kernel may
   launch in it: the recipe has no DCN.
8e. that checkpoint at serving, the fleet, AOT and the rungs: K1 and K2
   bitwise their plain versions, twice and from a CUDA graph, at the
   recipe's 16 int8 seams (41 a window; 5x5 taps, K split across clusters
   of up to 8 blocks) at B=1 and lanes 4, K2 at four large shapes (those
   past its staging read x twice); served at f32, bf16 and int8 on one
   replica at lanes 4 (the serving traffic, quantum 2: every request done,
   each within 1.0 dB of its f32 twin, K1 and K2 41 a window step at int8
   only; windows/s and p50/p99 per class and rung; a window's device ms
   through the harness at each rung); the int8 engine at lanes 4 x chunk 8
   (through K2's large path) within 1.0 dB of the f32 engine; the fleet at
   f32 (``run_fleet_scenario``: 3 replicas x 4 lanes, a handoff, a kill, a
   partition; zero lost, every stream within 1e-5 of its twin); and its
   depth-8 artifacts at f32 and int8 (exported in phase 10c's pool from
   seeded weights, loaded with the trained ones) bitwise the traced
   sessions.
8f. the data options and LPIPS: ``Trainer`` from ``configs/train_esr_2x.yml``
   as written at batch 32 with ``add_noise`` (noise level 0.1),
   ``hot_filter`` and ``sequence.pause`` (the shipped 0.05 / 0.9) on, no
   workers, rasterized on the card, over the graphs phase's recordings:
   the first batch's device-rasterized count images bitwise the host's of
   the same sequences (the noise in, the paused windows empty); 16
   iterations (``k_steps`` 8: an eager group, then a replay) twice, finite
   and bitwise run to run, 14/14/14 launches a step; the batch build with
   the options against without, in turns. Then the run's checkpoint through
   ``run_inference`` with ``allow_uncalibrated_lpips`` and with a seeded
   alex backbone npz: ``esr_lpips`` and ``bicubic_lpips`` in each report,
   every window's distances within 1e-4 relative of LPIPS on the CPU over
   the same images; the harness's per-window p50 with and without LPIPS,
   LPIPS's device ms a window. Last, phase 8d's card-against-CPU window
   again, three times (C10).

8. masked kernels: ``dcn_fwd_masked`` (B=1, 4, 8, 32) and
   ``dcn_train_fwd_masked`` (B=32) bitwise equal to their dense kernels on
   truthful masks (all active, all inactive, half the images zeroed and
   inactive, an explicit ``[B, n_tiles]`` mask, a NaN image kept active),
   within 1e-3 * max(|ref|, 1) of the plain ``deform_conv2d_masked``; times
   at 0, 50 and 100% active beside the dense kernel and the bound;
9. streaming engine: ``StreamingEngine`` on the sparse flagship
   (``dcn_sparse``) at lanes 4 x chunk_windows 8 over 6 seeded 720x1280
   recordings of unequal length: only ``dcn_fwd_masked``, 2 per window
   step; per-recording metrics within 1e-4 relative of the sequential
   harness; the plain DCN path within 1e-3; the host data path on the native
   route (its route counts); windows/s, chunk time and a profile of one
   chunk; the same run on the numpy route and on the native route again
   (metrics within 1e-6), each with its windows/s and the device idle share
   of the run (1 - chunks x a chunk's device-busy time / wall);
10. serving: ``ServingEngine`` on the same model, lanes 4, classes
   ``standard:8`` and ``gated:4:0.3``, 8 streams (4 bursty, 4 uniform) on a
   Poisson schedule at 8/s, preemption quantum 2, under an active telemetry
   sink with the live plane on (``live_port=0``): ``/metrics``,
   ``/healthz``, ``/slo`` and ``/snapshot`` each GET once from the main
   thread after 4 dispatched rounds and must answer 200; every request
   done, computed + skipped windows = the stream's windows, skips in
   ``gated``, preemptions, the session's telemetry through
   ``esr_tpu_torch.obs.report`` green against ``configs/slo.yml``, each
   preempted stream within 1e-5 of itself served alone, an ESRLANE1 round
   trip of a lane state bitwise; windows/s with and without a sink, in
   turns (live plane, none, sink);
10b. the fleet (``resilience.chaos_fleet.run_fleet_scenario`` at this
   width): the same 8 streams as a burst through a fault-free twin engine,
   then through 3 replicas x 4 lanes on the card behind ``FleetRouter``
   under ``build_fleet_plan(0)`` (a forced handoff, a killed and a
   partitioned replica), the fleet view fed by the supervisor's
   ``/snapshot`` polls. Fails unless: zero lost requests, all three faults
   fired and recovered over the merged router and replica files, the
   killed replica held a stream, every stream within 1e-5 of the twin with
   equal window counts, the merged report green against
   ``configs/slo_fleet.yml``, the killed replica stale in the fleet view.
   Prints the fleet's windows/s against the twin's, per-class p50/p99,
   handoffs, fail-overs, the supervisor's fetch p50, the launches and each
   abandoned replica's ``torch.cuda.memory_allocated`` before and after.
   Then ``serve.main --replicas 3 --fleet-port 0`` on the card (its
   default) over 4 load-generated streams: every request ok, the fleet's
   files written, the merged telemetry green against ``configs/slo.yml``;
10c. the AOT export: from a port checkpoint of the sparse flagship,
   ``inference.export.export_checkpoint(program="engine_chunk")`` at lanes
   4 for depths 8 and 4 (the serving classes') at f32 and int8, and for
   depth 8 at bf16 (its sessions serve every stream in the standard
   class), the five exports at once, a process each, beside the SR
   recipe's two of phase 8e; each export's seconds
   and bytes and each program's load ms printed; the serving phase's 8 streams replayed on a virtual clock (0.05 s a round, so both sessions bind,
   preempt and chunk alike) through a traced session and through
   ``aot_programs`` at each rung: every request's metrics, windows, skips
   and preemptions and the final lane states bitwise equal, the same
   launches (``dcn_fwd_masked`` 2 a window step; K1 and K2 at int8, which
   only the loaded artifact can have launched in that session); each
   program's build or load ms, the first chunk's readback and window
   p50/p99 beside the traced session's. Then ``serve.main --aot`` with one
   replica and with ``--replicas 2`` (each replica through an
   ``AotRegistry``), at once, a process each: every request ok, none
   lost, the artifact written, the process's ``dcn_fwd_masked`` launched;
11. the sparse train step: one B=32 step from the flagship config with
   ``model;args;dcn_sparse=true`` launches ``dcn_train_fwd_masked``,
   ``dcn_bwd`` and ``dcn_wgrad`` 14 times each; its losses and every grad
   bitwise the dense step's, and the dense step's bitwise its repeat;
12. the precision rungs: ``int8_conv`` (K1) and ``quantize_per_tensor``
   (K2) bitwise against their plain versions, twice (bitwise run to run),
   at every distinct seam shape of a flagship window at B=1 and at lanes 4
   (M, N, K and the launch plan printed; times through the op, the C entry
   point and inside a CUDA graph, whose replayed outputs must match, beside
   the previous design's recorded ones in the log, the bound at the int8 tensor rate, an empty
   kernel's launch and ``torch._int_mm`` over an im2col where it takes the
   shape); the harness over the slice's windows
   at f32, bf16 and int8 (per-window ESR PSNR and SSIM, the mean drop
   against f32 at most 1.0 dB, the reference's bound; launches per window:
   ``dcn_fwd`` 2, K1 and K2 once per seam at int8; a device profile of a
   window at each rung, naming the int8 kernels and counting their device
   operations a seam and the memsets); ``run_inference`` (what ``infer`` calls) on a
   checkpoint whose ``trainer.precision`` is bf16, without and with
   ``--precision w8a8``, and ``serve.main --precision int8``; the engine
   (lanes 4 x chunk 8) and serving at each rung, windows/s beside f32's,
   every recording and request within 1.0 dB of f32.

The phases run in the order 1-5, 8, 6, 9, 10, 10b, 10c, 12, 7 (with 11
inside 7), 8c, 8d, 8e, 8f, 7c, then the trainer's runtime.
The line before the last is the ``{"kernels": [...]}`` record (eight
kernels: the six DCN kernels and K1, K2); the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import atexit
import copy
import dataclasses
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import types
import zlib
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the f32
# rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
TOL = 1e-3  # scale-normalized, the reference's off-TPU f32 DCN bound
TINY = 1e-30  # the least scale a loss or gradient is normalized by
TRAIN_WINDOWS = 7  # L 9 - seqn 3 + 1
REPLACES = {
    "dcn_fwd": "esr_tpu/ops/dcn_pallas.py:326",
    "dcn_train_fwd": "esr_tpu/ops/dcn_pallas.py:551",
    "dcn_bwd": "esr_tpu/ops/dcn_pallas.py:1222",
    "dcn_wgrad": "esr_tpu/ops/dcn_pallas.py:1222",
    "dcn_fwd_masked": "esr_tpu/ops/dcn_pallas.py:358",
    "dcn_train_fwd_masked": "esr_tpu/ops/dcn_pallas.py:561",
}
# the int8 rung's kernels have no Pallas counterpart: the JAX package runs
# them through XLA
REPLACES.update({
    "int8_conv": "esr_tpu/config/quantize.py:120 (XLA's int8 conv; no Pallas kernel)",
    "quantize_per_tensor": "esr_tpu/config/quantize.py:87 (XLA; no Pallas kernel)",
})
# H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
PEAK_INT8_OPS_PER_S = 1979e12
# K1 and K2 of the previous design (K1's warps loading fragments straight
# from global memory, 4 warps stacked along M, K walked serially; K2 a
# memset, an amax pass and a quantize pass), as this script measured them on
# an NVIDIA H100 80GB HBM3 at 700.00 W, shown beside this run's in the
# per-shape log lines and nowhere else: (batch, NCHW input, Cout, kernel,
# stride) -> (K1 ms through the op, K1 entry ms, K2 ms through the op, K2
# entry ms)
EARLIER_INT8_MS = {
    (1, (3, 2, 96, 160), 8, 3, 1): (0.05631, 0.01448, 0.06389, 0.01924),
    (1, (3, 8, 96, 160), 16, 3, 2): (0.05233, 0.00909, 0.05516, 0.01312),
    (1, (3, 16, 48, 80), 32, 3, 2): (0.0562, 0.01393, 0.0668, 0.01955),
    (1, (3, 32, 24, 40), 64, 3, 2): (0.05184, 0.01409, 0.03869, 0.01327),
    (1, (1, 128, 12, 20), 64, 3, 1): (0.05561, 0.04103, 0.06573, 0.02276),
    (1, (1, 64, 12, 20), 1, 3, 1): (0.0345, 0.01337, 0.04106, 0.01357),
    (1, (1, 192, 12, 20), 192, 3, 1): (0.06054, 0.05988, 0.04151, 0.01438),
    (1, (1, 192, 12, 20), 64, 3, 1): (0.06685, 0.05687, 0.06564, 0.01247),
    (1, (1, 64, 12, 20), 64, 3, 1): (0.04992, 0.02782, 0.05738, 0.02858),
    (1, (3, 128, 12, 20), 64, 1, 1): (0.03012, 0.00915, 0.03627, 0.01276),
    (1, (1, 64, 12, 20), 216, 3, 1): (0.03362, 0.02318, 0.03415, 0.01318),
    (1, (1, 64, 12, 20), 2, 1, 1): (0.03354, 0.00863, 0.0381, 0.01154),
    (1, (1, 64, 1, 1), 32, 1, 1): (0.03069, 0.00812, 0.03725, 0.01211),
    (1, (1, 32, 1, 1), 128, 1, 1): (0.05, 0.01405, 0.05771, 0.01837),
    (1, (3, 64, 12, 20), 1, 3, 1): (0.03525, 0.01384, 0.03722, 0.01335),
    (1, (1, 64, 24, 40), 32, 3, 1): (0.03362, 0.01395, 0.03741, 0.0179),
    (1, (3, 32, 24, 40), 1, 3, 1): (0.03212, 0.00854, 0.03821, 0.01271),
    (1, (1, 32, 48, 80), 16, 3, 1): (0.04503, 0.00894, 0.04126, 0.01838),
    (1, (3, 16, 48, 80), 1, 3, 1): (0.05095, 0.00888, 0.05702, 0.01202),
    (1, (1, 16, 96, 160), 8, 3, 1): (0.03385, 0.01435, 0.0484, 0.02058),
    (1, (1, 8, 96, 160), 2, 3, 1): (0.06045, 0.01531, 0.07243, 0.02047),
    (4, (12, 2, 96, 160), 8, 3, 1): (0.03987, 0.01277, 0.05516, 0.01681),
    (4, (12, 8, 96, 160), 16, 3, 2): (0.04001, 0.01201, 0.04763, 0.01709),
    (4, (12, 16, 48, 80), 32, 3, 2): (0.06235, 0.01453, 0.07224, 0.02147),
    (4, (12, 32, 24, 40), 64, 3, 2): (0.03358, 0.014, 0.0401, 0.01323),
    (4, (4, 128, 12, 20), 64, 3, 1): (0.04289, 0.04231, 0.04167, 0.01402),
    (4, (4, 64, 12, 20), 1, 3, 1): (0.05255, 0.01399, 0.05508, 0.01746),
    (4, (4, 192, 12, 20), 192, 3, 1): (0.06012, 0.05887, 0.0504, 0.02016),
    (4, (4, 192, 12, 20), 64, 3, 1): (0.06126, 0.06037, 0.0635, 0.01957),
    (4, (4, 64, 12, 20), 64, 3, 1): (0.03461, 0.02323, 0.04023, 0.01424),
    (4, (12, 128, 12, 20), 64, 1, 1): (0.05334, 0.01481, 0.06288, 0.01754),
    (4, (4, 64, 12, 20), 216, 3, 1): (0.05454, 0.02309, 0.06137, 0.01946),
    (4, (4, 64, 12, 20), 2, 1, 1): (0.03728, 0.00907, 0.04076, 0.01355),
    (4, (4, 64, 1, 1), 32, 1, 1): (0.06025, 0.01497, 0.07138, 0.01868),
    (4, (4, 32, 1, 1), 128, 1, 1): (0.03863, 0.0092, 0.05346, 0.01238),
    (4, (12, 64, 12, 20), 1, 3, 1): (0.0415, 0.01365, 0.04535, 0.01563),
    (4, (4, 64, 24, 40), 32, 3, 1): (0.03746, 0.01413, 0.03985, 0.01221),
    (4, (12, 32, 24, 40), 1, 3, 1): (0.03381, 0.00987, 0.04673, 0.01348),
    (4, (4, 32, 48, 80), 16, 3, 1): (0.03521, 0.01195, 0.04239, 0.01469),
    (4, (12, 16, 48, 80), 1, 3, 1): (0.06151, 0.01478, 0.07129, 0.01891),
    (4, (4, 16, 96, 160), 8, 3, 1): (0.04007, 0.01514, 0.07705, 0.01653),
    (4, (4, 8, 96, 160), 2, 3, 1): (0.06179, 0.01663, 0.04508, 0.01904),
}
# the reference's bound on a rung's ESR PSNR drop against f32
# (bench.py:INT8_PSNR_DROP_BOUND_DB), held at int8 and at bf16
PSNR_DROP_DB = 1.0
RUNGS = ("f32", "bf16", "int8")
ENGINE_TOL = 1e-4  # engine vs the sequential harness, relative
SERVE_TOL = 1e-5  # a preempted stream vs the same stream served alone, relative
LANES = 4
CHUNK_WINDOWS = 8
# the flagship's evaluation data config (configs/train_esr_2x.yml)
FLAGSHIP_DATA = {
    "scale": 2, "ori_scale": "down16", "time_bins": 1, "mode": "events",
    "window": 2048, "sliding_window": 1024, "need_gt_events": True,
    "need_gt_frame": False,
    "data_augment": {"enabled": False, "augment": [], "augment_prob": []},
    "sequence": {"sequence_length": 9, "seqn": 3, "step_size": None,
                 "pause": {"enabled": False}},
    # the items the loops here read (the dataset builds every key by default)
    "item_keys": ["inp_scaled_cnt", "gt_cnt", "inp_cnt"],
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def dcn_inputs(torch, rng, b, h, w, cin, cout, dg, ho=None, wo=None,
               offset_scale=2.0, with_mask=True, with_bias=True):
    import numpy as np

    ho = h if ho is None else ho
    wo = w if wo is None else wo

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    mask = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, ho, wo, dg, 9))))
            if with_mask else np.ones((b, ho, wo, dg, 9)))
    return dict(
        x=t(rng.standard_normal((b, h, w, cin))),
        offsets=t(rng.standard_normal((b, ho, wo, dg, 9, 2)) * offset_scale),
        mask=t(mask),
        weight=t(rng.standard_normal((3, 3, cin, cout)) * 0.1),
        bias=t(rng.standard_normal(cout)) if with_bias else None,
    )


def kernel_cases():
    """(name, dcn_inputs shape kwargs, geometry kwargs): the dg / size /
    mask / stride / dilation / large-offset matrix."""
    cases = []
    for dg in (1, 2, 4):
        for h, w in ((7, 9), (13, 5), (4, 150)):
            for with_mask in (True, False):
                cases.append((f"dg{dg}_{h}x{w}_mask{int(with_mask)}",
                              dict(b=2, h=h, w=w, cin=4 * dg, cout=8, dg=dg,
                                   offset_scale=3.0, with_mask=with_mask,
                                   with_bias=False), {}))
    cases.append(("large_offsets", dict(b=1, h=6, w=7, cin=16, cout=8, dg=2,
                                        offset_scale=10.0), {}))
    # stride 2, padding 2, dilation 2: (9, 11) -> (5, 6)
    cases.append(("stride2_pad2_dil2", dict(b=1, h=9, w=11, cin=8, cout=6, dg=2,
                                            ho=5, wo=6),
                  dict(stride=2, padding=2, dilation=2)))
    # 16 channels per group, 6 out-channels: W and the output take the
    # scalar edge (Cout % 4 != 0), the backward its Cg 32 instantiation
    cases.append(("cg16_cout6", dict(b=2, h=9, w=13, cin=32, cout=6, dg=2), {}))
    # 3 channels per group: every kernel's gather takes its scalar path
    cases.append(("cg3_cout5", dict(b=2, h=7, w=9, cin=6, cout=5, dg=2), {}))
    return cases


def time_ms(torch, fn, iters: int, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline(nbytes: float, flops: float):
    """Least time (ms) for the work: the larger of bytes at the HBM rate and
    f32 FLOPs at the f32 rate, and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def contraction_flops(inp: dict) -> float:
    b, ho, wo, _, k, _ = inp["offsets"].shape
    _, _, cin, cout = inp["weight"].shape
    return 2.0 * b * ho * wo * k * cin * cout


def gather_flops(inp: dict) -> float:
    """The bilinear gather: per (row, tap, channel) 4 corner FMAs + the mask."""
    b, ho, wo, _, k, _ = inp["offsets"].shape
    cin = inp["x"].shape[-1]
    return 10.0 * b * ho * wo * k * cin


def nbytes(*tensors) -> float:
    return 4.0 * sum(t.numel() for t in tensors if t is not None)


def err_of(torch, got, ref):
    """(max abs err, limit) under the scale-normalized bound."""
    err = float((got - ref).abs().max())
    return err, TOL * max(float(ref.abs().max()), 1.0)


def rel_err_of(torch, got, ref):
    """(max abs err, the reference's own scale max|ref|, limit TOL * scale):
    for losses and gradients, whose scale may be far below 1."""
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    return err, scale, TOL * max(scale, TINY)


def device_union_ms(torch, prof) -> float:
    """The time the card was busy in a ``torch.profiler`` capture, in ms:
    the union of its kernels' and copies' intervals. A sum of their
    durations counts twice where they overlap (a kernel launched with
    programmatic dependent launch starts before the one ahead of it ends),
    and can pass the wall."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda and e.time_range.end > e.time_range.start)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3


def device_busy_ms(torch, prof) -> float:
    """:func:`device_union_ms`, failing when the profiler saw no device time."""
    busy = device_union_ms(torch, prof)
    if busy <= 0:
        fail("the profiler saw no device time")
    return busy


def device_time_breakdown(torch, prof, n: int, wall_ms: float, what: str, card: str):
    """Device busy / idle share and the top kernels of a ``torch.profiler``
    capture over ``n`` units of ``what``."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    # device-side entries only (kernels, copies): a CPU op's own device time
    # repeats the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if e.device_type == cuda and dev_us(e) > 0]
    if not events:
        print(f"profile {what}: device time not measured (the profiler saw no device events)")
        return None
    # busy: the union of the device intervals; the kernels below: summed
    busy_ms = device_union_ms(torch, prof) / n
    print(f"profile on {card}: {n} {what}s, wall {wall_ms:.3f} ms/{what}, device busy "
          f"{busy_ms:.3f} ms/{what} (the union of its kernels' intervals; their summed "
          f"time {sum(dev_us(e) for e in events) / 1e3 / n:.3f}), idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"profile kernel: {dev_us(e) / 1e3 / n:.4f} ms/{what}, "
              f"{e.count / n:g} calls/{what}: {e.key[:90]}")
    return busy_ms


def profile_windows(torch, model, loader, dev, card, n: int = 3) -> None:
    """Where one inference window's time goes over ``n`` forwards."""
    from torch.profiler import ProfilerActivity, profile

    batches = [torch.from_numpy(b["inp_scaled_cnt"][:, :3]).to(dev)
               for _, b in zip(range(n), loader)]
    states = model.init_states(1, *loader.gt_resolution, device=dev)
    with torch.no_grad():
        model(batches[0], states)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for x in batches:
                _, states = model(x, states)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    device_time_breakdown(torch, prof, len(batches), wall_ms, "window", card)


def phase_fwd_kernel(torch, np, card):
    """Phase 3: ``dcn_fwd`` against the plain version, at the evaluation
    batch (1), 4, the trainer's validation batch (8) and the training batch
    (32, where it runs the same body as ``dcn_train_fwd``)."""
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.ops.dcn import deform_conv2d
    from esr_tpu_torch.ops.dcn_cuda import dcn_fwd

    lib = dcn_cuda.FWD_LIBRARY.load()
    rng = np.random.default_rng(0)
    flagship = {}
    worst_rel = 0.0
    cases = [(f"flagship_b{b}", dict(b=b, h=12, w=20, cin=64, cout=64, dg=8), {})
             for b in (1, 4, 8, 32)]
    # the 4x recipe's bottleneck (a 180x320 HR grid padded to 192x320, /8)
    # at its validation batch
    cases.append(("valid_4x_b8", dict(b=8, h=24, w=40, cin=64, cout=64, dg=8), {}))
    timed = {name for name, _, _ in cases}
    for name, shape, geom in cases + kernel_cases():
        inp = dcn_inputs(torch, rng, **shape)
        out = dcn_fwd(**inp, **geom)
        ref = deform_conv2d(**inp, **geom)
        torch.cuda.synchronize()
        err, limit = err_of(torch, out, ref)
        print(f"kernel {name}: out {tuple(out.shape)} max_abs_err {err:.3e} (limit {limit:.3e})")
        if not bool(torch.isfinite(out).all()) or not err <= limit:
            fail(f"dcn_fwd disagrees with the plain version on {name}")
        worst_rel = max(worst_rel, err * TOL / limit)
        if name in timed:
            b = shape["b"]
            entry = fwd_entry(torch, lib, "dcn_fwd_f32", inp, torch.empty_like(out),
                              dcn_cuda.fwd_config(b * shape["h"] * shape["w"], 64))
            ms = time_ms(torch, lambda: dcn_fwd(**inp, **geom), iters=300)
            entry_ms = time_ms(torch, entry, iters=300)
            plain_ms = time_ms(torch, lambda: deform_conv2d(**inp, **geom), iters=50)
            bound_ms, bound_by = roofline(nbytes(*inp.values(), out),
                                          contraction_flops(inp) + gather_flops(inp))
            flagship[name] = dict(err=err, ms=ms, entry_ms=entry_ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
            print(f"time {name}: kernel {ms:.5f} ms through the op (entry point "
                  f"{entry_ms:.5f}), plain "
                  f"{plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) on {card}")
            if name in ("flagship_b1", "flagship_b32"):
                config_sweep(torch, inp, card)
    batch_invariance(torch, rng)
    return flagship, worst_rel


def batch_invariance(torch, rng):
    """Every image of a B=4 and a B=32 ``dcn_fwd`` call bitwise equal to
    the same image alone at B=1 (each output is one FMA chain in a fixed
    order, whatever the batch's configuration)."""
    from esr_tpu_torch.ops.dcn_cuda import dcn_fwd

    inp = dcn_inputs(torch, rng, b=32, h=12, w=20, cin=64, cout=64, dg=8)

    def images(lo, n):
        return {k: (v[lo:lo + n].contiguous() if k in ("x", "offsets", "mask") else v)
                for k, v in inp.items()}

    alone = torch.cat([dcn_fwd(**images(i, 1)) for i in range(32)])
    for b, out in ((32, dcn_fwd(**inp)),
                   (4, torch.cat([dcn_fwd(**images(i, 4)) for i in range(0, 32, 4)]))):
        torch.cuda.synchronize()
        if not same_bits(torch, out, alone):
            fail(f"an image of a B={b} dcn_fwd call differs from the same image at B=1")
    print("batch invariance: every image of the B=4 and B=32 dcn_fwd calls is bitwise "
          "the same image at B=1")


def fwd_entry(torch, lib, entry, inp, out, cfg, geom=None, am=None, tiling=None):
    """A launch of a forward entry point straight through its C function
    (not counted), at configuration ``cfg``; ``am`` and ``tiling`` (n_tiles,
    no_tile) for the masked ones."""
    x, off, mask, wt, bias = (inp[k] for k in ("x", "offsets", "mask", "weight", "bias"))
    b, h, w, cin = x.shape
    _, ho, wo, dg, _, _ = off.shape
    kh, kw, _, cout = wt.shape
    geom = geom or {}
    stride, pad, dil = (geom.get(k, d) for k, d in (("stride", 1), ("padding", 1), ("dilation", 1)))
    fn = getattr(lib, entry)
    masked = [am.data_ptr()] if am is not None else []

    def launch():
        rc = fn(x.data_ptr(), off.data_ptr(), mask.data_ptr(), wt.data_ptr(),
                bias.data_ptr() if bias is not None else None, out.data_ptr(), *masked,
                b, h, w, cin, ho, wo, cout, dg, kh, kw, stride, pad, dil,
                cfg.tm, cfg.tn, cfg.rm, *(tiling or ()), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"{entry} at {cfg} returned cudaError {rc}")
    return launch


def config_sweep(torch, inp, card):
    """The forward body's time over the chooser's candidates, straight
    through the C entry point (not counted), beside the one it picks; every
    candidate's output must be bitwise the picked one's."""
    from esr_tpu_torch.ops import dcn_cuda

    lib = dcn_cuda.FWD_LIBRARY.load()
    b, ho, wo, _, _, _ = inp["offsets"].shape
    cout = inp["weight"].shape[-1]
    pick = dcn_cuda.fwd_config(b * ho * wo, cout)
    ref = torch.empty((b, ho, wo, cout), device="cuda")
    fwd_entry(torch, lib, "dcn_fwd_f32", inp, ref, pick)()
    times = {}
    for cfg in dcn_cuda.fwd_candidates(cout):
        out = torch.empty_like(ref)
        launch = fwd_entry(torch, lib, "dcn_fwd_f32", inp, out, cfg)
        times[cfg] = time_ms(torch, launch, iters=200)
        torch.cuda.synchronize()
        if not same_bits(torch, out, ref):
            fail(f"dcn_fwd at {cfg} is not bitwise the picked configuration's output")
    print(f"config sweep B={b} on {card}: " + "; ".join(
        f"{c.tm}x{c.tn} rm{c.rm} {ms:.5f} ms" for c, ms in times.items())
        + f"; the chooser picks {pick.tm}x{pick.tn} rm{pick.rm}; all bitwise equal")


def bwd_config_of(inp):
    from esr_tpu_torch.ops import dcn_cuda

    _, h, w, cin = inp["x"].shape
    _, ho, wo, dg, k, _ = inp["offsets"].shape
    return dcn_cuda.bwd_config(h, w, ho, wo, cin, inp["weight"].shape[-1], dg, k)


def geometry_args(inp):
    """(B, H, W, Cin, Ho, Wo, Cout, dg, kh, kw, stride 1, padding 1, dilation 1)."""
    b, h, w, cin = inp["x"].shape
    _, ho, wo, dg, _, _ = inp["offsets"].shape
    kh, kw, _, cout = inp["weight"].shape
    return (b, h, w, cin, ho, wo, cout, dg, kh, kw, 1, 1, 1)


def bwd_entry(torch, lib, inp, g, cfg):
    """A call of ``dcn_bwd_pixel_f32`` alone (not counted), its outputs and
    scratch made once: the entry point's time, its scratch zeroing, bound
    pass and fixed-point conversion included."""
    from esr_tpu_torch.ops import dcn_cuda

    x, off, mask, wt = (inp[k] for k in ("x", "offsets", "mask", "weight"))
    gx = torch.empty_like(x)
    goff, gmask = torch.empty_like(off), torch.empty_like(mask)
    scratch = dcn_cuda.bwd_scratch(x, cfg)

    def launch():
        rc = lib.dcn_bwd_pixel_f32(x.data_ptr(), off.data_ptr(), mask.data_ptr(), wt.data_ptr(),
                                   g.data_ptr(), gx.data_ptr(), goff.data_ptr(), gmask.data_ptr(),
                                   scratch.data_ptr(),
                                   *geometry_args(inp), cfg.chunk_rows, cfg.tp, cfg.kt,
                                   int(cfg.own), cfg.to, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"dcn_bwd_pixel_f32 returned cudaError {rc}")
    return launch


def wgrad_entry(torch, lib, inp, g):
    """A launch of ``dcn_wgrad_f32`` alone (not counted; the partials' sum,
    which the wrapper adds, left out), at the chooser's configuration."""
    from esr_tpu_torch.ops import dcn_cuda

    x, off, mask, wt = (inp[k] for k in ("x", "offsets", "mask", "weight"))
    args = geometry_args(inp)
    cfg = dcn_cuda.dcn_wgrad.launch_config(x, off, wt.shape)
    partial = torch.empty((cfg.chunks(args[0] * args[4] * args[5]), wt.numel()),
                          device=x.device)

    def launch():
        rc = lib.dcn_wgrad_f32(x.data_ptr(), off.data_ptr(), mask.data_ptr(), g.data_ptr(),
                               partial.data_ptr(), *args, cfg.tj, cfg.to, cfg.mo,
                               cfg.chunk_rows,
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"dcn_wgrad_f32 at {cfg} returned cudaError {rc}")
    return launch


# the train-direction cases that are timed: the flagship at the training
# batch and at B=1, the bottlenecks of basech 16, 32, 48 and 64 at batch 32
# and of basech 128 at batch 4 (Cg 48-128 take dcn_bwd's wide kernel), and
# the 4x recipe's bottleneck (24x40) at its batch 8
TIMED_TRAIN_CASES = ("train_flagship_b32", "train_flagship_b1", "train_basech16_b32",
                     "train_basech32_b32", "train_basech48_b32", "train_basech64_b32",
                     "train_basech128_b4", "train_4x_b8")
# dcn_bwd's entry point at those cases in PR 6 (gx by float atomics; PERF.md
# section 6, NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's
PR6_BWD_ENTRY_MS = {"train_flagship_b32": 0.1192, "train_flagship_b1": 0.1040,
                    "train_basech16_b32": 0.476, "train_basech32_b32": 3.129,
                    "train_basech48_b32": 3.416, "train_basech64_b32": 5.176,
                    "train_basech128_b4": 3.237}


def phase_train_kernels(torch, np, card):
    """Phase 4: the train-direction kernels against their plain versions;
    returns the times of each timed case by kernel, and the worst
    scale-normalized error of each kernel over all cases."""
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.ops.dcn import deform_conv2d, deform_conv2d_backward
    from esr_tpu_torch.ops.dcn_cuda import dcn_bwd, dcn_train_fwd, dcn_wgrad

    rng = np.random.default_rng(1)
    worst_rel = {"dcn_train_fwd": 0.0, "dcn_bwd": 0.0, "dcn_wgrad": 0.0}
    record = {}
    # the flagship's and basech 16's and 32's images fit shared memory (the
    # backward's ownership path); a 64x64 image of 32 channels per group
    # does not (the global vector-red path); 48 channels per group and more
    # take the wide kernel
    cases = [("train_flagship_b32", dict(b=32, h=12, w=20, cin=64, cout=64, dg=8), {}),
             ("train_flagship_b1", dict(b=1, h=12, w=20, cin=64, cout=64, dg=8), {}),
             ("train_basech16_b32", dict(b=32, h=12, w=20, cin=128, cout=128, dg=8), {}),
             ("train_basech32_b32", dict(b=32, h=12, w=20, cin=256, cout=256, dg=8), {}),
             ("train_basech48_b32", dict(b=32, h=12, w=20, cin=384, cout=384, dg=8), {}),
             ("train_basech64_b32", dict(b=32, h=12, w=20, cin=512, cout=512, dg=8), {}),
             ("train_basech128_b4", dict(b=4, h=12, w=20, cin=1024, cout=1024, dg=8), {}),
             ("train_4x_b8", dict(b=8, h=24, w=40, cin=64, cout=64, dg=8), {}),
             ("bwd_global_64x64", dict(b=1, h=64, w=64, cin=64, cout=64, dg=2), {})]
    for name, shape, geom in cases + kernel_cases():
        inp = dcn_inputs(torch, rng, **shape)
        x, off, mask, wt, bias = (inp[k] for k in ("x", "offsets", "mask", "weight", "bias"))
        b, ho, wo = off.shape[:3]
        path = bwd_config_of(inp)
        wide = shape["cin"] // shape["dg"] > 32
        if name.startswith(("train_", "bwd_global")) and (
                path.own != (name.startswith("train_") and not wide) or (path.to > 0) != wide):
            fail(f"dcn_bwd on {name} took {path}")
        g = torch.from_numpy(rng.standard_normal(
            (b, ho, wo, wt.shape[-1])).astype(np.float32)).cuda()
        out = dcn_train_fwd(**inp, **geom)
        gx, goff, gmask = dcn_bwd(x, off, mask, wt, g, **geom)
        gw = dcn_wgrad(x, off, mask, wt.shape, g, **geom)
        ref_out = deform_conv2d(**inp, **geom)
        rgx, rgoff, rgmask, rgw, _ = deform_conv2d_backward(x, off, mask, wt, g, **geom)
        torch.cuda.synchronize()
        errs = {}
        for kname, what, got, ref in (("dcn_train_fwd", "out", out, ref_out),
                                      ("dcn_bwd", "gx", gx, rgx),
                                      ("dcn_bwd", "goffsets", goff, rgoff),
                                      ("dcn_bwd", "gmask", gmask, rgmask),
                                      ("dcn_wgrad", "gweight", gw, rgw)):
            err, limit = err_of(torch, got, ref)
            if not bool(torch.isfinite(got).all()) or not err <= limit:
                fail(f"{kname} {what} disagrees with the plain version on {name}: "
                     f"{err:.3e} > {limit:.3e}")
            worst_rel[kname] = max(worst_rel[kname], err * TOL / limit)
            errs[kname] = max(errs.get(kname, 0.0), err)
            print(f"kernel {name} {kname} {what}: max_abs_err {err:.3e} (limit {limit:.3e})"
                  + (f" [{'wide' if path.to else 'ownership' if path.own else 'global red'}"
                     f" path]" if kname == "dcn_bwd" and what == "gx" else "")
                  + (f" [{dcn_wgrad.launch_config(x, off, wt.shape)}]" if kname == "dcn_wgrad"
                     else ""))
        if name not in TIMED_TRAIN_CASES:
            continue
        # every output, gx too (64-bit fixed point), the same bits run to run
        gx2, goff2, gmask2 = dcn_bwd(x, off, mask, wt, g, **geom)
        gw2 = dcn_wgrad(x, off, mask, wt.shape, g, **geom)
        out2 = dcn_train_fwd(**inp, **geom)
        torch.cuda.synchronize()
        pairs = (("out", out, out2), ("gx", gx, gx2), ("goffsets", goff, goff2),
                 ("gmask", gmask, gmask2), ("gweight", gw, gw2))
        differ = [n for n, a, c in pairs if not same_bits(torch, a, c)]
        print(f"run to run on {name}: "
              + ("every output bitwise" if not differ else f"{differ} differ"))
        if differ:
            fail(f"{differ} on {name} are not bitwise equal from run to run")

        def plain_grad(*leaf_names):
            leaves = {k: v.detach().clone().requires_grad_(k in leaf_names)
                      for k, v in (("x", x), ("offsets", off), ("mask", mask), ("weight", wt))}
            o = deform_conv2d(**leaves, **geom)
            return torch.autograd.grad(o, [leaves[k] for k in leaf_names], g)

        lib = dcn_cuda.TRAIN_LIBRARY.load()
        timings = {
            "dcn_train_fwd": (lambda: dcn_train_fwd(**inp, **geom),
                              lambda: deform_conv2d(**inp, **geom),
                              fwd_entry(torch, lib, "dcn_train_fwd_f32", inp, torch.empty_like(out),
                                        dcn_cuda.fwd_config(b * ho * wo, out.shape[-1]))),
            "dcn_bwd": (lambda: dcn_bwd(x, off, mask, wt, g, **geom),
                        lambda: plain_grad("x", "offsets", "mask"),
                        bwd_entry(torch, lib, inp, g, path)),
            "dcn_wgrad": (lambda: dcn_wgrad(x, off, mask, wt.shape, g, **geom),
                          lambda: plain_grad("weight"), wgrad_entry(torch, lib, inp, g)),
        }
        flops = contraction_flops(inp)
        bounds = {
            "dcn_train_fwd": roofline(nbytes(x, off, mask, wt, bias, out),
                                      flops + gather_flops(inp)),
            "dcn_bwd": roofline(nbytes(x, off, mask, wt, g, gx, goff, gmask),
                                flops + 2 * gather_flops(inp)),
            "dcn_wgrad": roofline(nbytes(x, off, mask, g, gw), flops + gather_flops(inp)),
        }
        record[name] = {}
        iters = 200 if flops < 1e10 else 20
        for kname, (kernel_fn, plain_fn, entry_fn) in timings.items():
            ms = time_ms(torch, kernel_fn, iters=iters)
            entry_ms = time_ms(torch, entry_fn, iters=iters)
            plain_ms = (time_ms(torch, plain_fn, iters=20, warmup=3)
                        if name.startswith(("train_flagship", "train_4x")) else
                        time_ms(torch, plain_fn, iters=5, warmup=2))
            bound_ms, bound_by = bounds[kname]
            record[name][kname] = dict(err=errs[kname], ms=ms, entry_ms=entry_ms,
                                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            before = (f"; PR 6's entry point (float atomics, PERF.md) "
                      f"{PR6_BWD_ENTRY_MS[name]} ms"
                      if kname == "dcn_bwd" and name in PR6_BWD_ENTRY_MS else "")
            print(f"time {name} {kname}: kernel {ms:.5f} ms through the op (entry point "
                  f"{entry_ms:.5f}), "
                  f"plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) on {card}"
                  + before)
    return record, worst_rel


def phase_autograd(torch, np):
    """Phase 5: gradients through the model's DCN on the card."""
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.ops.dcn import deform_conv2d

    rng = np.random.default_rng(2)
    inp = dcn_inputs(torch, rng, b=2, h=12, w=20, cin=64, cout=64, dg=8)
    grads = {}
    for path in ("kernel", "plain"):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in inp.items()}
        dcn_cuda.reset_launches()
        fn = dcn_cuda.dcn if path == "kernel" else deform_conv2d
        out = fn(**leaves)
        if path == "kernel" and out.grad_fn is None:
            fail("the card's DCN output has no grad_fn")
        (out ** 2).sum().backward()
        torch.cuda.synchronize()
        if path == "kernel":
            counts = {k.name: k.launches for k in dcn_cuda.KERNELS}
            if counts != {"dcn_fwd": 0, "dcn_train_fwd": 1, "dcn_bwd": 1, "dcn_wgrad": 1,
                          "dcn_fwd_masked": 0, "dcn_train_fwd_masked": 0}:
                fail(f"the autograd DCN launched {counts}")
        grads[path] = {k: v.grad for k, v in leaves.items()}
    for k, ref in grads["plain"].items():
        got = grads["kernel"][k]
        if got is None:
            fail(f"no gradient reached {k} through the card's DCN")
        err, limit = err_of(torch, got, ref)
        print(f"autograd {k}: max_abs_err {err:.3e} (limit {limit:.3e})")
        if not err <= limit:
            fail(f"the autograd DCN's gradient of {k} differs from the plain path")
    try:
        dcn_cuda.dcn_fwd(**{k: v.detach().requires_grad_(True) for k, v in inp.items()})
    except RuntimeError:
        print("autograd: dcn_fwd refuses inputs that require grad")
    else:
        fail("dcn_fwd returned a tensor cut off from the graph")


def phase_slice(torch, np, dev, card):
    """Phase 6: sequential inference at the flagship width."""
    from esr_tpu_torch.data.loader import InferenceSequenceLoader
    from esr_tpu_torch.data.synthetic import make_synthetic_recording
    from esr_tpu_torch.inference.harness import InferenceRunner
    from esr_tpu_torch.models import convert
    from esr_tpu_torch.models.esr import DeepRecurrNet
    from esr_tpu_torch.ops import dcn_cuda

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    recording = make_synthetic_recording(
        (720, 1280), base_events=80_000, num_frames=2, rungs=("down8", "down16"),
        seed=0,
    )
    dataset_config = {
        "scale": 2, "ori_scale": "down16", "time_bins": 1, "mode": "events",
        "window": 2048, "sliding_window": 1024, "need_gt_events": True,
        "need_gt_frame": False,
        "data_augment": {"enabled": False, "augment": [], "augment_prob": []},
        "sequence": {"sequence_length": 9, "seqn": 3, "step_size": None,
                     "pause": {"enabled": False}},
    }
    torch.manual_seed(0)
    tree = convert.export_flax_params(DeepRecurrNet(inch=2, basech=8, num_frame=3))
    om = tree["params"]["spacetime_fuse"]["dcn_offset_mask"]
    om["kernel"] = (rng.standard_normal(om["kernel"].shape) * 0.05).astype(np.float32)
    om["bias"] = rng.standard_normal(om["bias"].shape).astype(np.float32)
    model = DeepRecurrNet(inch=2, basech=8, num_frame=3)
    convert.load_flax_params(model, tree)
    runner = InferenceRunner(model, seqn=3, device=dev)
    print(f"slice setup: {time.perf_counter() - t0:.2f} s")

    dcn_cuda.reset_launches()
    t0 = time.perf_counter()
    result = runner.run_recording(recording, dataset_config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in dcn_cuda.KERNELS}
    n_windows = int(result["n_windows"])
    print(f"slice: {n_windows} windows in {wall:.3f} s, launches {counts}")
    if n_windows < 8:
        fail(f"the recording gave {n_windows} windows, expected >= 8")
    if counts != only("dcn_fwd", 2 * n_windows):
        fail(f"the slice launched {counts} for {n_windows} windows")
    if not all(math.isfinite(v) for v in result.values()):
        fail(f"non-finite metrics: {result}")
    print("slice metrics: " + json.dumps({k: result[k] for k in sorted(result)}))

    # every window again, kernel path and plain path side by side
    loader = InferenceSequenceLoader(recording, {**dataset_config,
                                                 "item_keys": FLAGSHIP_DATA["item_keys"]})
    kh, kw = loader.gt_resolution
    states_k = model.init_states(1, kh, kw, device=dev)
    states_p = model.init_states(1, kh, kw, device=dev)
    worst = 0.0
    lat = []
    with torch.no_grad():
        for i, batch in enumerate(loader):
            inp = torch.from_numpy(batch["inp_scaled_cnt"][:, :3]).to(dev)
            model.spacetime_fuse.dcn_impl = "auto"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_k, states_k = model(inp, states_k)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            model.spacetime_fuse.dcn_impl = "plain"
            out_p, states_p = model(inp, states_p)
            for a, r in ((out_k, out_p), (states_k[0], states_p[0]),
                         (states_k[1], states_p[1])):
                if not bool(torch.isfinite(a).all()):
                    fail(f"non-finite output or state in window {i}")
                err, limit = err_of(torch, a, r)
                worst = max(worst, err * TOL / limit)
                if not err <= limit:
                    fail(f"window {i}: kernel path differs from plain by {err:.3e}")
            if tuple(out_k.shape) != (1, kh, kw, 2):
                fail(f"window {i}: output shape {tuple(out_k.shape)}")
    model.spacetime_fuse.dcn_impl = "auto"
    profile_windows(torch, model, loader, dev, card)
    lat_sorted = sorted(lat)
    print(f"slice vs plain: {len(lat)} windows, worst scale-normalized err "
          f"{worst:.3e} (limit {TOL})")
    print(f"slice latency per window on {card}: mean harness {result['time'] * 1e3:.3f} ms; "
          f"replay p50 {lat_sorted[len(lat) // 2]:.3f} ms, max {lat_sorted[-1]:.3f} ms")
    evaluate_checkpoint(np, dev, tree, recording, dataset_config, result)
    return counts["dcn_fwd"]


def decode_png(np, path: str):
    """The pixels of a PNG as the port writes it (8-bit RGB or gray, rows
    unfiltered); every chunk's CRC checked."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path} is not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            fail(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color, _, _, _ = header
    ch = {2: 3, 0: 1}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    if depth != 8 or rows[:, 0].any():
        fail(f"{path}: depth {depth} or filtered rows")
    return rows[:, 1:].reshape((h, w, 3) if ch == 3 else (h, w))


def evaluate_checkpoint(np, dev, tree, recording, dataset_config, want):
    """The slice's weights saved as a port checkpoint (``params.npz`` +
    ``config.json``, the exporter's output format) and evaluated through
    ``run_inference``, the function ``python -m esr_tpu_torch.infer`` calls,
    with ``save_images`` and no engine (this machine has no h5py, so the
    recording stays in memory): the metrics those of the slice's run (the
    same weights, data and kernels) within 1e-5 relative, 6 PNG views per
    window in the reference's tree, each decoding to an image of its grid,
    and window 0's views equal to their renders."""
    from esr_tpu_torch.data.loader import InferenceSequenceLoader
    from esr_tpu_torch.inference.checkpoint import save_checkpoint
    from esr_tpu_torch.inference.harness import IMG_DIRS, run_inference
    from esr_tpu_torch.utils.vis_events import render_event_cnt

    root = tempfile.mkdtemp(prefix="chip_smoke_infer_")
    try:
        ckpt = os.path.join(root, "ckpt")
        save_checkpoint(ckpt, tree, {
            "model": {"name": "DeepRecurrNet", "args": {"inch": 2, "basech": 8, "num_frame": 3}},
            "inference": {"engine": True}})
        t0 = time.perf_counter()
        mean = run_inference(ckpt, [recording], os.path.join(root, "out"), dataset_config,
                             save_images=True, engine=False, device=dev)
        wall = time.perf_counter() - t0
        worst = max(abs(mean[k] - want[k]) / max(abs(want[k]), 1e-12)
                    for k in ("esr_mse", "esr_psnr", "esr_ssim", "bicubic_mse", "n_windows"))
        if not worst <= 1e-5:
            fail(f"the saved checkpoint evaluates {worst:.3e} away from the slice's run")
        rec_dir = Path(root) / "out" / recording.name
        n = int(want["n_windows"])
        pngs = sorted(str(p.relative_to(rec_dir)) for p in rec_dir.rglob("*.png"))
        want_tree = sorted([f"event_img/{d}/{i:09d}.png" for d in IMG_DIRS for i in range(n)]
                           + [f"img/gt_img/{i:09d}.png" for i in range(n)])
        if pngs != want_tree:
            fail(f"infer --save_images wrote {len(pngs)} PNGs, not the reference's tree "
                 f"of {len(want_tree)}")
        loader = InferenceSequenceLoader(recording, {**dataset_config,
                                                     "item_keys": FLAGSHIP_DATA["item_keys"]})
        (h, w), (kh, kw) = loader.inp_resolution, loader.gt_resolution
        for name in pngs:
            img = decode_png(np, str(rec_dir / name))
            grid = (h, w) if name.startswith("event_img/lr_") else (kh, kw)
            if img.shape[:2] != grid:
                fail(f"{name} decodes to {img.shape}, expected the {grid} grid")
        window = next(iter(loader))
        for d, key in (("lr_event_img", "inp_cnt"), ("hr_scaled_event_img", "inp_scaled_cnt"),
                       ("hr_gt_event_img", "gt_cnt")):
            got = decode_png(np, str(rec_dir / "event_img" / d / f"{0:09d}.png"))
            if not np.array_equal(got, render_event_cnt(window[key][0, 1])):
                fail(f"{d}/000000000.png does not decode to its render")
        print(f"checkpoint -> infer --save_images --no_engine: {n} windows in {wall:.3f} s, "
              f"metrics within {worst:.3e} of the slice's, {len(pngs)} PNGs in the "
              f"reference's tree, each decoded, window 0's count views equal to their renders")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def training_recordings(np):
    """In-memory 720x1280 recordings: 4 for training, each long enough for
    32 sequences of L 9 at window 2048 / sliding 1024 (>= 288 windows at
    down16), so one epoch holds 4 batches of 32; 1 short one to validate."""
    from esr_tpu_torch.data.synthetic import make_synthetic_recording

    def rec(events, seed):
        return make_synthetic_recording((720, 1280), base_events=events, num_frames=2,
                                        rungs=("down8", "down16"), seed=seed)

    return [rec(300_000, 10 + i) for i in range(4)], [rec(40_000, 20)]


def phase_train(torch, np, dev, card, repo: Path, out_root: str):
    """Phase 7: the trainer at the flagship width."""
    from torch.profiler import ProfilerActivity, profile

    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.data.loader import collate_sequences
    from esr_tpu_torch.inference.checkpoint import load_checkpoint
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.training.checkpoint import find_latest_checkpoint
    from esr_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    train_recs, valid_recs = training_recordings(np)
    print(f"train setup: recordings in {time.perf_counter() - t0:.2f} s")
    # the flagship config as written: only the run's length and paths are set
    overrides = [
        f"trainer;output_path={out_root}",
        "trainer;iteration_based_train;iterations=4",
        "trainer;iteration_based_train;valid_step=2",
        "trainer;iteration_based_train;save_period=2",
        "trainer;iteration_based_train;train_log_step=1",
    ]
    run = RunConfig.from_args(str(repo / "configs" / "train_esr_2x.yml"),
                              overrides=overrides, runid="chip_smoke", seed=0)
    trainer = Trainer(run, device=dev, train_recordings=train_recs,
                      valid_recordings=valid_recs)
    batch_size = run.config["train_dataloader"]["batch_size"]
    print(f"train: {len(trainer.train_loader)} batches of {batch_size} per epoch, "
          f"{len(trainer.valid_loader)} validation batches")
    if len(trainer.train_loader) < trainer.iterations:
        fail("one epoch holds fewer batches than iterations")

    per_step, per_valid, step_ms = [], [], []
    train_step, valid = trainer.train_step, trainer._valid

    def counts():
        return {k.name: k.launches for k in dcn_cuda.KERNELS}

    def delta(before):
        return {n: c - before[n] for n, c in counts().items()}

    def counted_step(batch):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append(delta(before))
        return metrics

    def counted_valid():
        before = counts()
        result = valid()
        per_valid.append(delta(before))
        return result

    saved, save = [], trainer._save

    def recorded_save(iteration, best):
        saved.append(iteration)
        return save(iteration, best)

    trainer.train_step, trainer._valid, trainer._save = counted_step, counted_valid, recorded_save
    dcn_cuda.reset_launches()
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = counts()
    trainer.train_step, trainer._valid = train_step, valid
    print(f"train: {len(per_step)} steps + {len(per_valid)} validations in {wall:.3f} s; "
          f"result {json.dumps(result)}")
    print(f"train launches per step {per_step}; per validation {per_valid}")
    want_step = {"dcn_fwd": 0, "dcn_train_fwd": 2 * TRAIN_WINDOWS,
                 "dcn_bwd": 2 * TRAIN_WINDOWS, "dcn_wgrad": 2 * TRAIN_WINDOWS,
                 "dcn_fwd_masked": 0, "dcn_train_fwd_masked": 0}
    if len(per_step) != trainer.iterations or any(c != want_step for c in per_step):
        fail(f"train steps launched {per_step}, each should be {want_step}")
    n_valid_windows = len(trainer.valid_loader) * TRAIN_WINDOWS
    want_valid = only("dcn_fwd", 2 * n_valid_windows)
    if len(per_valid) != 1 or per_valid != [want_valid]:
        fail(f"validation launched {per_valid}, should be [{want_valid}]")

    with open(trainer.log_path) as f:
        log = [json.loads(line) for line in f]
    train_log = [r for r in log if "train_loss" in r]
    print("train log: " + json.dumps(log))
    # the cadences are the group's (k_steps, the reference's super-steps):
    # the epoch's batches make one group, validated and saved after its last
    group_last = min(trainer.k_steps, len(trainer.train_loader)) - 1
    stamps = [r["iteration"] for r in log if "valid_stamp" in r]
    if group_last + 1 == trainer.iterations and (stamps != [group_last]
                                                 or saved != [group_last]):
        fail(f"validated at {stamps} and saved at {saved}; the group of {group_last + 1} "
             f"steps should validate and save once, after iteration {group_last}")
    if (len(train_log) != trainer.iterations or not all(
            math.isfinite(r[k]) for r in train_log for k in ("train_loss", "grad_norm"))
            or not all(math.isfinite(v) for v in result.values())):
        fail("non-finite or missing losses / grad norms")
    check_writer_records(run, trainer)

    ckpt = find_latest_checkpoint(os.path.dirname(run.save_dir))
    if ckpt is None or not ckpt.endswith(f"checkpoint-iteration{trainer.iterations - 1}"):
        fail(f"no committed final checkpoint (found {ckpt})")
    files = {p.name: p.stat().st_mtime_ns for p in Path(ckpt).iterdir()}
    if "digest.json" not in files or files["meta.json"] < max(files.values()):
        fail(f"the commit marker was not written last, or no digest: {files}")
    loaded, _ = load_checkpoint(ckpt)
    loaded = loaded.to(dev).eval()
    dataset = trainer.train_loader.dataset
    t0 = time.perf_counter()
    batch = collate_sequences([dataset.get_item(i, seed=i) for i in range(batch_size)])
    build_ms = (time.perf_counter() - t0) * 1e3
    sel = trainer._select(batch)
    with torch.no_grad():
        states = loaded.init_states(batch_size, *sel["inp"].shape[2:4], device=dev)
        out, _ = loaded(sel["inp"][:, :3], states)
    if not bool(torch.isfinite(out).all()):
        fail("the loaded checkpoint's forward is not finite")
    print(f"checkpoint {Path(ckpt).name}: loads, forward {tuple(out.shape)} finite")
    checkpoint_ways(torch, trainer, ckpt, os.path.join(out_root, "checkpoint_ways"), card)
    batch_build(np, train_recs, dataset.config, batch_size, card)
    device_rasterize_step(torch, dev, trainer, repo, overrides, train_recs, valid_recs)

    # one validation pass (batch 8) on the kernel path and on the plain path
    valid_out = {}
    for path in ("kernel", "plain"):
        trainer.model.spacetime_fuse.dcn_impl = "auto" if path == "kernel" else "plain"
        dcn_cuda.reset_launches()
        valid_out[path] = valid()
        torch.cuda.synchronize()
        if path == "kernel" and counts() != want_valid:
            fail(f"the kernel-path validation launched {counts()}, should be {want_valid}")
        if path == "plain" and any(counts().values()):
            fail(f"the plain-path validation launched {counts()}")
    trainer.model.spacetime_fuse.dcn_impl = "auto"
    for key in ("valid_loss", "valid_mse_loss"):
        e, scale, lim = rel_err_of(torch, torch.tensor(valid_out["kernel"][key]),
                                   torch.tensor(valid_out["plain"][key]))
        print(f"validation kernel vs plain (batch {trainer.valid_loader.sampler.batch_size}): "
              f"{key} {valid_out['kernel'][key]!r} vs {valid_out['plain'][key]!r}, "
              f"max_abs_err {e:.3e} (scale {scale:.3e}, limit {lim:.3e})")
        if not e <= lim:
            fail(f"the kernel path's {key} differs from the plain path's")

    step_kernel_vs_plain(torch, trainer, sel)

    c2_bitwise_step(torch, trainer, sel)
    sparse_launches = sparse_train_step(torch, dev, trainer, sel, repo, overrides)

    # where a train step's time goes
    for _ in range(2):  # warm
        train_step(sel)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(sel)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    trainer.model.spacetime_fuse.dcn_impl = "plain"
    plain_times = []
    for i in range(4):  # the first warms the plain path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(sel)
        torch.cuda.synchronize()
        plain_times.append((time.perf_counter() - t0) * 1e3)
    trainer.model.spacetime_fuse.dcn_impl = "auto"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(sel)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    print(f"train step on {card}: batch {batch_size}, step (host clock to synchronize) "
          f"{sorted(times)[1]:.3f} ms median of {len(times)} ({', '.join(f'{t:.3f}' for t in times)}); "
          f"in the run {', '.join(f'{t:.3f}' for t in step_ms)} ms; host batch build "
          f"{build_ms:.3f} ms for {batch_size} sequences of L 9; the same step on the plain "
          f"DCN path {sorted(plain_times[1:])[1]:.3f} ms median of 3 "
          f"({', '.join(f'{t:.3f}' for t in plain_times[1:])}); the trainer's run "
          f"{wall:.3f} s for {trainer.iterations} iterations in groups of {trainer.k_steps}, "
          f"1 validation, {len(saved)} save(s) at {saved}")
    device_time_breakdown(torch, prof, 1, prof_ms, "train step", card)
    basech_step(torch, np, dev, trainer, sel, repo, overrides, card, sorted(times)[1], 16)
    # basech 64 (Cg 64: dcn_bwd's wide kernel) at batch 4
    basech_step(torch, np, dev, trainer, {k: v[:4] for k, v in sel.items()}, repo,
                overrides, card, None, 64, f64=True)
    return totals, sparse_launches, (train_recs, valid_recs)


GRAPH_K = 8  # the flagship's k_steps
GRAPH_ITERATIONS = 2 * GRAPH_K + 1  # two full groups, then a tail of one


def graph_recordings(np):
    """In-memory 720x1280 recordings for the graphs phase: 17 of 32
    sequences of L 9 (an epoch of 17 batches of 32: two full groups of 8 and
    a tail of 1), and 5 to validate (160 sequences: 20 batches of 8, two
    chunks of 8 and a tail of 4)."""
    from esr_tpu_torch.data.synthetic import make_synthetic_recording

    def rec(events, seed):
        return make_synthetic_recording((720, 1280), base_events=events, num_frames=2,
                                        rungs=("down8", "down16"), seed=seed)

    return ([rec(300_000, 100 + i) for i in range(GRAPH_ITERATIONS)],
            [rec(300_000, 200 + i) for i in range(5)])


def train_state(torch, trainer):
    """The parameters and Adam's moments of ``trainer``, copied on the card."""
    params = [p.detach().clone() for p in trainer.model.parameters()]
    moments = [v.detach().clone() for st in trainer.optimizer.optimizer.state.values()
               for k, v in sorted(st.items()) if k != "step"]
    return params, moments


def track_groups(torch, trainer, at):
    """Record each step's loss, and after each group that ends at an
    iteration in ``at`` the parameters and moments (every visit: a rollback
    replays iterations)."""
    rec = {"losses": {}, "state": {}}
    consume = trainer._consume

    def recorded(first, epoch, n, lrs, t0, metrics, bucket, nan_specs):
        out = consume(first, epoch, n, lrs, t0, metrics, bucket, nan_specs)
        for j, m in enumerate(metrics):
            rec["losses"].setdefault(first + j, []).append(m["loss"].detach().clone())
        last = first + len(metrics) - 1
        if last in at:
            rec["state"].setdefault(last, []).append(train_state(torch, trainer))
        return out

    trainer._consume = recorded
    return rec


def same_state(torch, a, b) -> bool:
    return (len(a[0]) == len(b[0]) and len(a[1]) == len(b[1])
            and all(same_bits(torch, x, y) for x, y in zip(a[0] + a[1], b[0] + b[1])))


def group_times(torch, trainer, batches, card, what: str = "the flagship",
                dcn: bool = True):
    """A full group of ``trainer``'s recipe (the flagship at batch 32 unless
    ``what`` names another), eagerly (its train steps) and captured (the
    batches copied into the slots, one replay), one after the other; device busy, idle
    share and peak memory of an eager step and of a replayed group under
    the profiler (the device only: an eager group's ~40,000 launches take a
    minute to aggregate), and, with ``dcn``, the DCN kernels it saw in the
    replay."""
    from torch.profiler import ProfilerActivity, profile

    multi = trainer.multi_step
    k = len(batches)

    def eager():
        for b in batches:
            trainer.train_step(b)

    def captured():
        for j, b in enumerate(batches):
            multi.load(j, b)
        multi()

    # the graph's pool: captured anew from an emptied cache
    multi.release()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    captured()
    torch.cuda.synchronize()
    pool_gib = (torch.cuda.memory_reserved() - reserved0) / 2**30
    times = {"eager": [], "captured": []}
    for way in ("eager", "captured"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (eager if way == "eager" else captured)()
        torch.cuda.synchronize()
        times[way].append((time.perf_counter() - t0) * 1e3)
    busy, peak = {}, {}
    for way, fn in (("eager", lambda: trainer.train_step(batches[0])),
                    ("captured", captured)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        peak[way] = (torch.cuda.max_memory_allocated() - base) / 2**30
        busy[way] = (device_busy_ms(torch, prof), wall)
        if way == "captured" and dcn:
            seen = {}
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    for name in ("dcn_forward_kernel", "dcn_bwd_pixel", "dcn_wgrad_kernel"):
                        if name in e.key:
                            seen[name] = seen.get(name, 0) + e.count
            print(f"graphs: the profiler saw in one replay {seen} (kernels of the graph, "
                  f"{k} steps)")
            want = {"dcn_forward_kernel": k * 2 * TRAIN_WINDOWS,
                    "dcn_bwd_pixel": k * 2 * TRAIN_WINDOWS,
                    "dcn_wgrad_kernel": k * 2 * TRAIN_WINDOWS}
            if seen != want:
                fail(f"the profiler saw {seen} DCN kernels in a replayed group, expected {want}")
    batch = batches[0]["inp"].shape[0]
    windows = k * batch * TRAIN_WINDOWS
    for way in ("eager", "captured"):
        med = sum(times[way]) / len(times[way])
        b_ms, wall = busy[way]
        unit = "a step" if way == "eager" else "the group"
        idle = f"idle share {1 - b_ms / wall:.3f}"
        print(f"graphs on {card}: {what} group ({k} steps of batch {batch}), {way}: "
              f"{', '.join(f'{t:.3f}' for t in times[way])} ms (mean {med:.3f}; a step "
              f"{med / k:.3f} ms), {windows / (med / 1e3):.1f} windows/s; profiled, {unit}: "
              f"device busy {b_ms:.3f} ms of {wall:.3f} ms ({idle}); peak memory above the "
              f"state {peak[way]:.3f} GiB"
              + (" outside the graph's pool" if way == "captured" else ""))
    print(f"graphs on {card}: {what}'s captured group's memory pool {pool_gib:.3f} GiB "
          "(memory reserved by its capture)")


def phase_graphs(torch, np, dev, card, repo: Path, out_root: str):
    """Phase 8c: the flagship recipe as written (``k_steps`` 8, fused
    validation) with its full groups as CUDA graph replays, bitwise the
    ``k_steps: 1`` run, also across a rollback; fused validation against the
    per-batch pass; the engine's graphed chunk bitwise the eager chunk at
    every rung, dense and sparse; captured against eager times."""
    from itertools import islice

    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.resilience import faults
    from esr_tpu_torch.training.multistep import launch_counts
    from esr_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()

    def at(what: str) -> None:
        print(f"graphs: {what} at {time.perf_counter() - t_phase:.1f} s into the phase")

    train_recs, valid_recs = graph_recordings(np)
    print(f"graphs setup: recordings in {time.perf_counter() - t_phase:.2f} s")
    groups_at = {GRAPH_K - 1, 2 * GRAPH_K - 1, GRAPH_ITERATIONS - 1}

    def trainer_of(name, extra=()):
        # the flagship as written; run length and paths set, saves and
        # validation off for the comparison
        overrides = [f"trainer;output_path={os.path.join(out_root, name)}",
                     f"trainer;iteration_based_train;iterations={GRAPH_ITERATIONS}",
                     "trainer;iteration_based_train;valid_step=1000000000",
                     "trainer;iteration_based_train;save_period=1000000000",
                     "trainer;iteration_based_train;train_log_step=1", *extra]
        run = RunConfig.from_args(str(repo / "configs" / "train_esr_2x.yml"),
                                  overrides=overrides, runid="chip_smoke_graphs", seed=0)
        return Trainer(run, device=dev, train_recordings=train_recs,
                       valid_recordings=valid_recs)

    runs = {}
    for name, extra, plan in (
            ("k1", ["trainer;k_steps=1"], None),
            ("k8", [], None),
            ("k8_rollback", ["trainer;max_bad_steps=0"],
             faults.FaultPlan([faults.FaultSpec("train_step", GRAPH_K, "nan_loss")]))):
        trainer = trainer_of(name, extra)
        at(f"trainer {name} built")
        if name == "k1" and len(trainer.train_loader) != GRAPH_ITERATIONS:
            fail(f"the graphs phase's epoch holds {len(trainer.train_loader)} batches, "
                 f"not {GRAPH_ITERATIONS}")
        rec = track_groups(torch, trainer, groups_at)
        reset_all_launches()
        t0 = time.perf_counter()
        if plan is None:
            trainer.train()
        else:
            with faults.installed(plan):
                trainer.train()
        torch.cuda.synchronize()
        runs[name] = {"trainer": trainer, "rec": rec, "launches": launch_counts(),
                      "wall": time.perf_counter() - t0}
        print(f"graphs: run {name} ({trainer.k_steps} steps a group), {GRAPH_ITERATIONS} "
              f"iterations in {runs[name]['wall']:.3f} s; launches {runs[name]['launches']}")

    want = {n: (GRAPH_ITERATIONS * 2 * TRAIN_WINDOWS
                if n in ("dcn_train_fwd", "dcn_bwd", "dcn_wgrad") else 0)
            for n in launch_counts()}
    for name in ("k1", "k8"):
        if runs[name]["launches"] != want:
            fail(f"run {name} launched {runs[name]['launches']}, expected {want} "
                 "(14/14/14 a step)")
    eight = runs["k8"]["trainer"]
    opt = eight.optimizer
    if not (opt.capturable and all(g["lr"] is opt.lr_tensor for g in opt.optimizer.param_groups)
            and float(opt.lr_tensor) == float(np.float32(opt.schedule(opt.count - 1)))):
        fail("the optimizer's updates do not read the device lr the schedule wrote")
    graph = eight.multi_step.graph
    per_group = {n: GRAPH_K * 2 * TRAIN_WINDOWS for n in ("dcn_train_fwd", "dcn_bwd",
                                                          "dcn_wgrad")}
    if graph is None or graph.replays != 1 or graph.launches != per_group:
        fail(f"the k_steps 8 run should replay its second group once from a graph that "
             f"captured {per_group}: graph {graph and (graph.replays, graph.launches)}")
    print(f"graphs: counted launches = eager steps' launches + the {graph.launches} captured "
          f"a group x {graph.replays} replay(s); 14/14/14 a step in both runs")
    k8_launches, graph_launches = runs["k8"]["launches"], dict(graph.launches)

    ref = runs["k1"]["rec"]
    for name in ("k8", "k8_rollback"):
        got = runs[name]["rec"]
        bad = [i for i in range(GRAPH_ITERATIONS)
               if not same_bits(torch, got["losses"][i][-1], ref["losses"][i][-1])]
        if bad or sorted(got["losses"]) != list(range(GRAPH_ITERATIONS)):
            fail(f"run {name}: the losses at iterations {bad} differ from k_steps 1's")
        for it in sorted(groups_at):
            if not same_state(torch, got["state"][it][-1], ref["state"][it][-1]):
                fail(f"run {name}: the parameters or moments after iteration {it} differ "
                     "from k_steps 1's")
        n_params = len(ref["state"][GRAPH_ITERATIONS - 1][-1][0])
        print(f"graphs: run {name}: {GRAPH_ITERATIONS} losses, {n_params} parameters and "
              f"their Adam moments after the groups ending at {sorted(groups_at)} bitwise "
              "the k_steps 1 run's")
    if n_params != 68:
        fail(f"the flagship has {n_params} parameters, expected 68")
    rb = runs["k8_rollback"]["trainer"]
    if rb._guard.rollbacks != 1 or rb.multi_step.graph.replays != 1:
        fail(f"the rollback run rolled back {rb._guard.rollbacks} times and replayed "
             f"{rb.multi_step.graph.replays} groups after it (expected 1 and 1)")
    print("graphs: the rollback run skipped group 2 (nan_loss), restored the run-start "
          "state (no moments yet), ran group 1 again as the warm-up, captured again and "
          "replayed group 2, to the k_steps 1 run's bits")

    # captured against eager, one group
    batches = [eight._select(b) for b in islice(iter(eight.train_loader), GRAPH_K)]
    at("the timed group's batches built")
    group_times(torch, eight, batches, card)
    del batches
    at("the group timed")

    # fused validation against the per-batch pass, on the k8 trainer's state
    n_valid = len(eight.valid_loader)
    if n_valid < 2 * eight.valid_chunk + 1 or n_valid % eight.valid_chunk == 0:
        fail(f"{n_valid} validation batches: not two chunks of {eight.valid_chunk} and a tail")
    out, pass_ms = {}, {"fused": [], "sequential": []}
    # the first fused pass captures its chunk, the second replays it
    for fused in (True, False, True):
        eight.valid_fused = fused
        way = "fused" if fused else "sequential"
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = eight._valid()
        torch.cuda.synchronize()
        pass_ms[way].append((time.perf_counter() - t0) * 1e3)
        want_valid = only("dcn_fwd", 2 * TRAIN_WINDOWS * n_valid)
        if counts_of() != want_valid:
            fail(f"the {way} validation launched {counts_of()}, expected {want_valid}")
        readbacks = 1 if fused else n_valid
        if eight.last_valid_readbacks != readbacks:
            fail(f"the {way} validation read back {eight.last_valid_readbacks} times, "
                 f"expected {readbacks}")
        out.setdefault(way, result)
    chunk = next(iter(eight._eval_chunks.values()))
    if chunk.graph is None or chunk.graph.replays < 2:
        fail("fused validation did not replay its chunk from a graph")
    for key in ("valid_loss", "valid_mse_loss"):
        f, s_ = out["fused"][key], out["sequential"][key]
        rel = abs(f - s_) / max(abs(s_), 1e-30)
        print(f"graphs: validation {key} fused {f!r} vs per batch {s_!r}: relative "
              f"{rel:.3e} (limit 1e-5)")
        if not rel <= 1e-5:
            fail(f"fused validation's {key} differs from the per-batch pass's")
    print(f"graphs on {card}: validation pass ({n_valid} batches of 8, chunks of "
          f"{eight.valid_chunk}; the first fused pass runs its first chunk eagerly and "
          f"captures; {chunk.graph.replays} chunk replays in all), fused "
          f"{', '.join(f'{t:.3f}' for t in pass_ms['fused'])} ms (1 readback) vs per batch "
          f"{', '.join(f'{t:.3f}' for t in pass_ms['sequential'])} ms ({n_valid} readbacks), "
          "in turns (fused, per batch, fused)")
    # the trainers and their graphs' pools go before the engine's graphs
    del runs, eight, rb, graph, chunk
    torch.cuda.empty_cache()
    at("validation done")

    engine_graphs(torch, np, dev, card)
    print(f"graphs phase {time.perf_counter() - t_phase:.1f} s")
    return {"k8": k8_launches, "graph": graph_launches, "recordings": (train_recs, valid_recs)}


def reset_all_launches():
    """Every hand-written kernel's launch count to 0, the DCN's and the
    int8 rung's."""
    from esr_tpu_torch.ops import dcn_cuda, int8_cuda

    dcn_cuda.reset_launches()
    int8_cuda.reset_launches()


def engine_graphs(torch, np, dev, card):
    """The engine's chunk as a CUDA graph: at f32, bf16 and int8, dense and
    sparse, 4 chunks of lanes 4 x 8 windows driven in lockstep through the
    graph and the eager ``ChunkProgram`` from the same states (the lane
    states, sums and SSIM pairs bitwise, the same launches); then the sparse
    flagship's engine run graphed, then eager, at f32 and int8."""
    from itertools import islice

    from torch.profiler import ProfilerActivity, profile

    from esr_tpu_torch.config.precision import compute_dtype_of, resolve_precision
    from esr_tpu_torch.data.loader import LanePackedChunks
    from esr_tpu_torch.data.synthetic import make_synthetic_recording
    from esr_tpu_torch.inference.engine import (
        GraphedChunk,
        StreamingEngine,
        lane_states,
        make_chunk_fn,
    )
    from esr_tpu_torch.training.multistep import launch_counts

    recs = [make_synthetic_recording((720, 1280), base_events=ev, num_frames=2,
                                     rungs=("down8", "down16"), seed=30 + i,
                                     name=f"engine{i}")
            for i, ev in enumerate((120_000, 200_000, 80_000, 160_000, 100_000, 140_000))]
    packer = LanePackedChunks(recs, FLAGSHIP_DATA, lanes=LANES, chunk_windows=CHUNK_WINDOWS)
    kh, kw = packer.gt_resolution
    host_chunks = list(islice(iter(packer), 4))
    staged = [{k: torch.from_numpy(v).to(dev)
               for k, v in dict(c["windows"], reset_keep=c["reset_keep"]).items()}
              for c in host_chunks]
    for sparse in (False, True):
        model = flagship_model(torch, np, dcn_sparse=sparse).to(dev).eval()
        for rung in RUNGS:
            precision = resolve_precision(cli=rung)
            dtype = compute_dtype_of(precision)
            program = make_chunk_fn(model, LANES, CHUNK_WINDOWS, kh, kw, dtype, precision)
            graphed = GraphedChunk(program)
            s_g = lane_states(model, LANES, kh, kw, dev, dtype)
            s_e = tuple(z.clone() for z in s_g)
            launched = {}
            for c in staged:
                windows = {k: c[k] for k in ("inp_scaled", "gt", "inp_mid", "valid")}
                for way in ("graphed", "eager"):
                    before = launch_counts()
                    if way == "graphed":
                        s_g, sums_g, st_g = graphed(s_g, c["reset_keep"], windows)
                    else:
                        s_e, sums_e, st_e = program(s_e, c["reset_keep"], windows)
                    torch.cuda.synchronize()
                    for n, v in launch_counts().items():
                        launched.setdefault(way, {}).setdefault(n, 0)
                        launched[way][n] += v - before[n]
                pairs = ([(a, b) for a, b in zip(s_g, s_e)]
                         + [(sums_g[k], sums_e[k]) for k in sums_e]
                         + [(st_g[k], st_e[k]) for k in st_e])
                if not all(tuple(a.shape) == tuple(b.shape) and torch.equal(
                        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
                        for a, b in pairs):
                    fail(f"engine chunk {rung} {'sparse' if sparse else 'dense'}: the graphed "
                         "chunk's states or sums differ from the eager chunk's")
            if graphed.graph is None or graphed.graph.replays != len(staged) - 1:
                fail(f"engine chunk {rung}: {graphed.graph and graphed.graph.replays} replays "
                     f"of {len(staged)} chunks")
            if launched["graphed"] != launched["eager"] or not any(launched["eager"].values()):
                fail(f"engine chunk {rung}: launches graphed {launched['graphed']} vs eager "
                     f"{launched['eager']}")
            print(f"graphs: engine chunk {rung} {'sparse' if sparse else 'dense'}: "
                  f"{len(staged)} chunks (1 eager, {graphed.graph.replays} replays), lane "
                  f"states, sums and SSIM pairs bitwise the eager chunk's; launches "
                  f"{ {n: v for n, v in launched['graphed'].items() if v} } each way")
            del graphed, program
    # windows/s, chunk ms and idle share, graphed against eager
    model = flagship_model(torch, np, dcn_sparse=True)
    for rung in ("f32", "int8"):
        engine = StreamingEngine(model, 3, lanes=LANES, chunk_windows=CHUNK_WINDOWS,
                                 precision=rung, device=dev)
        engine.run_datalist(recs[:2], FLAGSHIP_DATA)  # warm-up and capture
        graphed = engine._run_chunk
        stats = {"graphed": [], "eager": []}
        for way in ("graphed", "eager"):
            engine._run_chunk = graphed if way == "graphed" else graphed.program
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results, _ = engine.run_datalist(recs, FLAGSHIP_DATA)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_windows = int(sum(r["n_windows"] for r in results))
            chunk_ms = sorted(s * 1e3 for s in engine.chunk_seconds)
            stats[way].append((n_windows / wall, chunk_ms[len(chunk_ms) // 2], wall,
                               len(chunk_ms)))
        c = staged[1]
        windows = {k: c[k] for k in ("inp_scaled", "gt", "inp_mid", "valid")}
        states = lane_states(model.to(dev), LANES, kh, kw, dev,
                             compute_dtype_of(resolve_precision(cli=rung)))
        for way in ("graphed", "eager"):
            fn = graphed if way == "graphed" else graphed.program
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(states, c["reset_keep"], windows)
                torch.cuda.synchronize()
            busy = device_busy_ms(torch, prof)
            idle = ", ".join(f"{1 - n * busy / (w * 1e3):.3f}" for _, _, w, n in stats[way])
            print(f"graphs on {card}: engine {rung} (sparse flagship, lanes {LANES} x chunk "
                  f"{CHUNK_WINDOWS}), {way}: "
                  + ", ".join(f"{r:.3f}" for r, _, _, _ in stats[way])
                  + " windows/s; chunk (dispatch to readback) p50 "
                  + ", ".join(f"{p:.3f}" for _, p, _, _ in stats[way])
                  + f" ms; a chunk's device busy {busy:.3f} ms; idle share of the run {idle}")
        engine._run_chunk = graphed


SR_K = 8  # the captured group's k_steps
SR_ITERATIONS = 2 * SR_K + 1  # 17 batches of 8: two full groups, then a tail of 1
SR_BATCH = 8  # configs/train_srunet_2x.yml


def srunet_recordings(np, recs):
    """The train phase's recordings (four of 32 sequences of L 9: 16
    batches of 8) and one more of ~11 sequences, so an epoch of the SR
    recipe holds 17 batches of 8; the train phase's validation recording;
    and 5 recordings of unequal length to evaluate (the lanes refill)."""
    from esr_tpu_torch.data.synthetic import make_synthetic_recording

    def rec(events, seed, name=None):
        return make_synthetic_recording((720, 1280), base_events=events, num_frames=2,
                                        rungs=("down8", "down16"), seed=seed, name=name)

    train_recs, valid_recs = recs
    evals = [rec(ev, 50 + i, f"srunet_eval{i}")
             for i, ev in enumerate((120_000, 200_000, 80_000, 160_000, 100_000))]
    return train_recs + [rec(110_000, 40)], valid_recs, evals


def srunet_trainer(dev, repo: Path, out_dir: str, recs, iterations: int, extra=()):
    """``configs/train_srunet_2x.yml`` as written: only the run's length and
    paths are set (and ``extra``)."""
    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.training.trainer import Trainer

    overrides = [f"trainer;output_path={out_dir}",
                 f"trainer;iteration_based_train;iterations={iterations}",
                 "trainer;iteration_based_train;valid_step=2",
                 "trainer;iteration_based_train;save_period=2",
                 "trainer;iteration_based_train;train_log_step=1", *extra]
    run = RunConfig.from_args(str(repo / "configs" / "train_srunet_2x.yml"),
                              overrides=overrides, runid="chip_smoke_srunet", seed=0)
    return run, Trainer(run, device=dev, train_recordings=recs[0], valid_recordings=recs[1])


def cpu_identity() -> str:
    """The host CPU's architecture and model and the cores this process may
    use: an f32 CPU result depends on all three (the kernels the CPU's
    instruction set selects, and the thread team)."""
    import platform

    model = "model not listed"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f if ln.split(":", 1)[0].strip()
                          in ("model name", "Model", "CPU part")), model)
    except OSError:
        pass
    return f"{platform.machine()} {model}, {len(os.sched_getaffinity(0))} cores usable"


def srunet_window(torch, trainer, sel, device, dtype, threads=None):
    """One full-width window at B=1 from the trainer's weights on
    ``device`` at ``dtype`` (the CPU side at ``threads`` intra-op threads,
    then restored): ``(output, {name: gradient of the MSE})`` on the CPU."""
    saved = torch.get_num_threads()
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        model = copy.deepcopy(trainer.model).train().to(device=device, dtype=dtype)
        x, gt = sel["inp"][:1, :3].to(device, dtype), sel["gt"][:1, 1].to(device, dtype)
        states = tuple(s.to(dtype) for s in model.init_states(1, *x.shape[2:4], device=device))
        out, _ = model(x, states)
        ((out - gt) ** 2).mean().backward()
        return (out.detach().cpu(),
                {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    finally:
        torch.set_num_threads(saved)


def from_f64(torch, side, f64) -> dict:
    """A window's distance from the f64 run: the output's max abs error and
    the gradient farthest from f64 relative to its own scale."""
    out, grads = side
    worst = max(((n, float((g - f64[1][n]).abs().max()), float(f64[1][n].abs().max()))
                 for n, g in grads.items()), key=lambda r: r[1] / max(r[2], TINY))
    return {"output": float((out - f64[0]).abs().max()), "grad": worst[0],
            "grad_err": worst[1], "grad_scale": worst[2]}


def srunet_card_vs_cpu(torch, trainer, sel, cpu_threads=None, f64=None) -> dict:
    """One window at full width and B=1 from the trainer's weights, on the
    card and on the CPU (``cpu_threads`` intra-op threads; None keeps the
    process's): the output within 1e-3 * max(|ref|, 1), and every
    parameter's gradient of its MSE within 1e-3 of its own scale max|ref|
    (a gradient's scale may be far below 1). The numerics flags at the
    check, the host's CPU and each side's distance from the same window on
    the CPU in f64 are printed on every call, so a failure says which side
    strayed. Returns the distances and the f64 run (``f64`` reuses one)."""
    flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.benchmark": torch.backends.cudnn.benchmark,
             "deterministic": torch.are_deterministic_algorithms_enabled()}
    if flags["cudnn.allow_tf32"] or flags["matmul.allow_tf32"] or not flags["deterministic"]:
        fail(f"srunet card vs CPU: the numerics policy is not in force at the check: {flags}")
    card = srunet_window(torch, trainer, sel, next(trainer.model.parameters()).device,
                         torch.float32)
    cpu = srunet_window(torch, trainer, sel, "cpu", torch.float32, cpu_threads)
    if f64 is None:
        f64 = srunet_window(torch, trainer, sel, "cpu", torch.float64)
    err, lim = err_of(torch, card[0], cpu[0])
    rows = [(n, *rel_err_of(torch, card[1][n], g)) for n, g in cpu[1].items()]
    worst = max(rows, key=lambda r: r[1] / r[3])
    threads = torch.get_num_threads() if cpu_threads is None else cpu_threads
    free, total = torch.cuda.mem_get_info()
    dist = {"card": from_f64(torch, card, f64), "cpu": from_f64(torch, cpu, f64),
            "cpu_threads": threads, "output_err": err, "worst": worst[0],
            "worst_ratio": worst[1] / worst[3]}
    print(f"srunet card vs CPU: a window at B=1, {tuple(cpu[0].shape)} out, max_abs_err "
          f"{err:.3e} (limit {lim:.3e}); {len(rows)} gradients, the worst {worst[0]} "
          f"{worst[1]:.3e} of its scale {worst[2]:.3e} (limit {worst[3]:.3e}); CPU at "
          f"{threads} threads ({cpu_identity()}, default {torch.get_num_threads()}); "
          f"flags {json.dumps(flags)}; the card's memory {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB free")
    for way in ("card", "cpu"):
        d = dist[way]
        print(f"srunet card vs CPU: {way} against the CPU in f64: output {d['output']:.3e}, "
              f"farthest gradient {d['grad']} {d['grad_err']:.3e} of its scale "
              f"{d['grad_scale']:.3e} ({d['grad_err'] / max(d['grad_scale'], TINY):.3e})")
    bad = ([] if err <= lim else ["output"]) + [n for n, e, _, lim in rows if not e <= lim]
    if bad:
        for n in bad:
            side = {"card": card[0], "cpu": cpu[0]} if n == "output" else {
                "card": card[1][n], "cpu": cpu[1][n]}
            ref = f64[0] if n == "output" else f64[1][n]
            print(f"srunet card vs CPU: {n} against the CPU in f64 (scale "
                  f"{float(ref.abs().max()):.3e}): card {float((side['card'] - ref).abs().max()):.3e},"
                  f" CPU {float((side['cpu'] - ref).abs().max()):.3e}")
        fail(f"the SRUNet window on the card differs from the CPU's: {bad}")
    dist["f64"] = f64
    return dist


def srunet_graphs(torch, np, dev, card, repo: Path, out_root: str, recs) -> None:
    """The recipe with ``k_steps: 8`` on 17 batches (two full groups, the
    second captured and replayed, and a tail of 1) bitwise the ``k_steps:
    1`` run: the losses, the parameters and Adam's moments after each
    group; then a group's time captured against eager."""
    from itertools import islice

    groups_at = {SR_K - 1, 2 * SR_K - 1, SR_ITERATIONS - 1}
    runs = {}
    for name, extra in (("k1", ["trainer;k_steps=1"]), ("k8", [f"trainer;k_steps={SR_K}"])):
        _, trainer = srunet_trainer(dev, repo, os.path.join(out_root, name), recs,
                                    SR_ITERATIONS, extra + [
                                        "trainer;iteration_based_train;valid_step=1000000000",
                                        "trainer;iteration_based_train;save_period=1000000000"])
        if len(trainer.train_loader) != SR_ITERATIONS:
            fail(f"the SR recipe's epoch holds {len(trainer.train_loader)} batches of "
                 f"{SR_BATCH}, not {SR_ITERATIONS}")
        rec = track_groups(torch, trainer, groups_at)
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        runs[name] = {"trainer": trainer, "rec": rec, "wall": time.perf_counter() - t0}
        print(f"srunet graphs: run {name}, {SR_ITERATIONS} iterations in "
              f"{runs[name]['wall']:.3f} s")
    eight = runs["k8"]["trainer"]
    graph = eight.multi_step.graph
    if graph is None or graph.replays != 1:
        fail(f"the k_steps {SR_K} run should replay its second group once: "
             f"{graph and graph.replays}")
    ref, got = runs["k1"]["rec"], runs["k8"]["rec"]
    bad = [i for i in range(SR_ITERATIONS)
           if not same_bits(torch, got["losses"][i][-1], ref["losses"][i][-1])]
    if bad or sorted(got["losses"]) != list(range(SR_ITERATIONS)):
        fail(f"srunet k_steps {SR_K}: the losses at iterations {bad} differ from k_steps 1's")
    for it in sorted(groups_at):
        if not same_state(torch, got["state"][it][-1], ref["state"][it][-1]):
            fail(f"srunet k_steps {SR_K}: the parameters or moments after iteration {it} "
                 "differ from k_steps 1's")
    n_params = len(ref["state"][SR_ITERATIONS - 1][-1][0])
    print(f"srunet graphs: {SR_ITERATIONS} losses, {n_params} parameters and their Adam "
          f"moments after the groups ending at {sorted(groups_at)} bitwise the k_steps 1 "
          "run's (the second group a graph replay)")
    if n_params != 38:
        fail(f"the SR recipe has {n_params} parameters, expected 38")
    batches = [eight._select(b) for b in islice(iter(eight.train_loader), SR_K)]
    group_times(torch, eight, batches, card, what="the SRUNet recipe", dcn=False)
    del runs, eight, graph, batches
    torch.cuda.empty_cache()


def srunet_evaluate(torch, np, dev, card, ckpt: str, out_root: str, evals) -> None:
    """The trained checkpoint through ``run_inference`` (what ``python -m
    esr_tpu_torch.infer`` calls), by the sequential harness and by the
    engine (lanes 4 x chunk 8) on the checkpoint's validation data config:
    finite metrics, the engine within 1e-4 of the harness; the engine's
    graphed chunk bitwise the eager chunk; windows/s and the per-window p50."""
    from itertools import islice

    from esr_tpu_torch.config.parser import load_config
    from esr_tpu_torch.data.loader import LanePackedChunks
    from esr_tpu_torch.inference.checkpoint import load_checkpoint
    from esr_tpu_torch.inference.engine import (
        METRIC_KEYS, GraphedChunk, StreamingEngine, lane_states, make_chunk_fn)
    from esr_tpu_torch.inference.harness import InferenceRunner, run_inference

    model, config = load_checkpoint(ckpt)
    data = config["valid_dataloader"]["dataset"]
    reports, walls = {}, {}
    for way, engine in (("harness", False), ("engine", True)):
        out = os.path.join(out_root, f"eval_{way}")
        t0 = time.perf_counter()
        run_inference(ckpt, evals, out, engine=engine, device=dev, lanes=LANES,
                      chunk_windows=CHUNK_WINDOWS)
        walls[way] = time.perf_counter() - t0
        reports[way] = load_config(os.path.join(out, "inference_all.yml"))[
            "breakdown results for each data"]
    worst, n_windows = 0.0, 0
    for rec in evals:
        h = {k: reports["harness"][k][rec.name] for k in reports["harness"]}
        e = {k: reports["engine"][k][rec.name] for k in reports["engine"]}
        n_windows += int(h["n_windows"])
        if h["n_windows"] != e["n_windows"]:
            fail(f"srunet {rec.name}: the engine ran {e['n_windows']} windows, the harness "
                 f"{h['n_windows']}")
        for k in METRIC_KEYS + ("esr_rmse", "bicubic_rmse"):
            if not (math.isfinite(h[k]) and math.isfinite(e[k])):
                fail(f"srunet {rec.name}: {k} is not finite")
            worst = max(worst, abs(e[k] - h[k]) / max(abs(h[k]), 1e-12))
    print(f"srunet evaluation: the checkpoint through run_inference, {n_windows} windows of "
          f"{len(evals)} recordings; harness {walls['harness']:.3f} s, engine "
          f"{walls['engine']:.3f} s (each with its set-up); engine vs harness worst relative "
          f"metric difference {worst:.3e} (limit {ENGINE_TOL})")
    if not worst <= ENGINE_TOL:
        fail("the SRUNet engine's metrics differ from the sequential harness's")

    # the engine's chunk: graphed against eager, bitwise
    model = model.to(dev).eval()
    packer = LanePackedChunks(evals, data, lanes=LANES, chunk_windows=CHUNK_WINDOWS)
    kh, kw = packer.gt_resolution
    staged = [{k: torch.from_numpy(v).to(dev)
               for k, v in dict(c["windows"], reset_keep=c["reset_keep"]).items()}
              for c in islice(iter(packer), 3)]
    program = make_chunk_fn(model, LANES, CHUNK_WINDOWS, kh, kw)
    graphed = GraphedChunk(program)
    s_g = lane_states(model, LANES, kh, kw, dev)
    s_e = tuple(z.clone() for z in s_g)
    for c in staged:
        windows = {k: c[k] for k in ("inp_scaled", "gt", "inp_mid", "valid")}
        s_g, sums_g, st_g = graphed(s_g, c["reset_keep"], windows)
        s_e, sums_e, st_e = program(s_e, c["reset_keep"], windows)
        pairs = (list(zip(s_g, s_e)) + [(sums_g[k], sums_e[k]) for k in sums_e]
                 + [(st_g[k], st_e[k]) for k in st_e])
        if not all(same_bits(torch, a.contiguous(), b.contiguous()) for a, b in pairs):
            fail("srunet: the engine's graphed chunk differs from the eager chunk")
    if graphed.graph is None or graphed.graph.replays != len(staged) - 1:
        fail(f"srunet: {graphed.graph and graphed.graph.replays} chunk replays")
    print(f"srunet engine chunk: {len(staged)} chunks (1 eager, {graphed.graph.replays} "
          f"replays), {len(s_g)} lane-state leaves, sums and SSIM pairs bitwise the eager "
          "chunk's")
    del graphed, program, staged

    # windows/s of the engine (graphed) and the harness's per-window latency
    engine = StreamingEngine(model, 3, lanes=LANES, chunk_windows=CHUNK_WINDOWS, device=dev)
    engine.run_datalist(evals[:2], data)  # warm-up and capture
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, _ = engine.run_datalist(evals, data)
        torch.cuda.synchronize()
        rates.append(sum(r["n_windows"] for r in results) / (time.perf_counter() - t0))
    chunk_ms = sorted(s * 1e3 for s in engine.chunk_seconds)
    runner = InferenceRunner(model, 3, device=dev)
    forward, window_ms = runner.forward, []

    def timed(inp, states):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(inp, states)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    runner.forward = timed
    runner.run_recording(evals[1], data, report=False)
    window_ms = sorted(window_ms[1:])
    print(f"srunet evaluation on {card}: engine (lanes {LANES} x chunk {CHUNK_WINDOWS}, "
          f"graphed) {', '.join(f'{r:.3f}' for r in rates)} windows/s, chunk p50 "
          f"{chunk_ms[len(chunk_ms) // 2]:.3f} ms; harness a window (B=1, dispatch to "
          f"synchronize) p50 {window_ms[len(window_ms) // 2]:.3f} ms over {len(window_ms)} "
          f"windows (max {window_ms[-1]:.3f})")


def phase_srunet(torch, np, dev, card, repo: Path, out_root: str, recs) -> None:
    """Phase 8d: the second shipped recipe, ``configs/train_srunet_2x.yml``
    (``SRUNetRecurrentSeq``, f32), through the port's entry points on the
    card: 3 steps at batch 8 and a validation, the checkpoint reloaded; two
    identical steps bitwise; a window on the card against the CPU; the
    step's device time; ``k_steps: 8`` as a captured group bitwise the
    eager loop; the checkpoint evaluated by the harness and the engine. The
    recipe has no DCN: no hand-written kernel launches in the phase."""
    from torch.profiler import ProfilerActivity, profile

    from esr_tpu_torch.inference.checkpoint import load_checkpoint
    from esr_tpu_torch.training.checkpoint import find_latest_checkpoint
    from esr_tpu_torch.training.multistep import launch_counts

    t_phase = time.perf_counter()
    train_recs, valid_recs, evals = srunet_recordings(np, recs)
    reset_all_launches()
    run, trainer = srunet_trainer(dev, repo, os.path.join(out_root, "train"),
                                  (train_recs, valid_recs), 3)
    if run.config["model"]["name"] != "SRUNetRecurrentSeq" or trainer.k_steps != 1:
        fail("the SR recipe did not build SRUNetRecurrentSeq at k_steps 1")
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"srunet: {type(trainer.model).__name__} ({n_params} parameters), "
          f"{len(trainer.train_loader)} batches of {SR_BATCH} per epoch, "
          f"{len(trainer.valid_loader)} validation batch(es); built in "
          f"{time.perf_counter() - t_phase:.2f} s")
    if n_params != 3_222_546:
        fail(f"the SR recipe's model has {n_params} parameters, expected 3222546")
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(trainer.log_path) as f:
        log = [json.loads(line) for line in f]
    steps = [r for r in log if "train_loss" in r]
    stamps = [r["iteration"] for r in log if "valid_stamp" in r]
    if (len(steps) != 3 or len(stamps) != 1 or not all(
            math.isfinite(r[k]) for r in steps for k in ("train_loss", "grad_norm"))
            or not all(math.isfinite(v) for v in result.values())):
        fail(f"srunet: non-finite or missing losses, or not one validation: {log}")
    print(f"srunet train: 3 steps + 1 validation in {wall:.3f} s; losses "
          f"{[round(r['train_loss'], 6) for r in steps]}; result {json.dumps(result)}")
    ckpt = find_latest_checkpoint(os.path.dirname(run.save_dir))
    if ckpt is None or not ckpt.endswith("checkpoint-iteration2"):
        fail(f"srunet: no committed final checkpoint (found {ckpt})")
    loaded, _ = load_checkpoint(ckpt)
    for (n, p), q in zip(loaded.named_parameters(), trainer.model.parameters()):
        if not torch.equal(p, q.detach().cpu()):
            fail(f"srunet: the reloaded checkpoint's {n} differs from the trainer's")
    print(f"srunet checkpoint {Path(ckpt).name}: committed, reloads bitwise the trainer's "
          "parameters")

    sel = trainer._select(next(iter(trainer.train_loader)))
    c2_bitwise_step(torch, trainer, sel, what=f"B={SR_BATCH} SRUNet")
    srunet_card_vs_cpu(torch, trainer, sel)
    # the same window's weights and inputs, for phase 8f to repeat (C10)
    c10 = (copy.deepcopy(trainer.model).cpu(), {k: sel[k][:1].cpu() for k in ("inp", "gt")})

    # where a step's time goes
    for _ in range(2):  # warm
        trainer.train_step(sel)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(sel)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(sel)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"srunet train step on {card}: batch {SR_BATCH}, step (host clock to synchronize) "
          f"{sorted(times)[1]:.3f} ms median of 3 ({', '.join(f'{t:.3f}' for t in times)}); "
          f"peak memory above the state {peak:.3f} GiB")
    busy = device_time_breakdown(torch, prof, 1, prof_ms, "srunet train step", card)
    if busy is None:
        fail("srunet: the profiler saw no device time in a train step")
    print(f"srunet train step on {card}: device_busy_ms {busy:.3f}, wall {prof_ms:.3f} ms, "
          f"idle share {1 - busy / prof_ms:.3f}")
    del trainer, sel
    torch.cuda.empty_cache()

    srunet_graphs(torch, np, dev, card, repo, os.path.join(out_root, "graphs"),
                  (train_recs, valid_recs))
    srunet_evaluate(torch, np, dev, card, ckpt, out_root, evals)
    if any(launch_counts().values()):
        fail(f"the SRUNet phase launched hand-written kernels: {launch_counts()}")
    print(f"srunet phase {time.perf_counter() - t_phase:.1f} s; no hand-written kernel "
          "launched (the recipe has no DCN and runs at f32)")
    return ckpt, evals, c10


# Phase 8f: the flagship with the data options on (the shipped pause
# probabilities), two full k_steps groups (the first eager, the second a
# replay), run twice
OPTION_ITERATIONS = 2 * GRAPH_K
OPTION_OVERRIDES = [
    "train_dataloader;dataset;add_noise;enabled=true",
    "train_dataloader;dataset;add_noise;noise_level=0.1",
    "train_dataloader;dataset;hot_filter;enabled=true",
    "train_dataloader;dataset;sequence;pause;enabled=true",
    "train_dataloader;num_workers=0",
]
LPIPS_REL = 1e-4  # the card's per-window LPIPS against the port's CPU run, relative
C10_REPEATS = 3


def options_batch(np, cfg, recs, keys, batches: int = 0):
    """The first B=32 batch of a fresh loader over ``recs`` with ``cfg``
    and ``keys`` (each build in turn, no prefetch), and the ms a batch of
    the next ``batches``."""
    from esr_tpu_torch.data.loader import ConcatSequenceDataset, SequenceLoader

    loader = SequenceLoader(ConcatSequenceDataset(recs, {**cfg, "item_keys": keys}), 32,
                            seed=0, prefetch=0)
    it = iter(loader)
    first = next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    return first, (time.perf_counter() - t0) * 1e3 / max(batches, 1)


def options_training(torch, np, dev, card, repo: Path, out_root: str, recs) -> str:
    """The flagship as written at batch 32 with ``add_noise`` (0.1),
    ``hot_filter`` and ``sequence.pause`` on and ``device_rasterize``: a
    first batch rasterized on the card bitwise the host's count images of
    the same sequences (noise in, paused windows empty); 16 iterations
    (``k_steps`` 8: one eager group, one replayed) twice, finite and bitwise
    run to run (losses, parameters, Adam's moments), 14/14/14 launches a
    step; the batch build with the options against without. Returns the
    first run's final checkpoint."""
    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.data import np_encodings as NE
    from esr_tpu_torch.training.checkpoint import find_latest_checkpoint
    from esr_tpu_torch.training.multistep import launch_counts
    from esr_tpu_torch.training.trainer import RAW_KEYS, TRAIN_KEYS, Trainer

    train_recs, valid_recs = recs

    def trainer_of(name):
        overrides = [f"trainer;output_path={os.path.join(out_root, name)}",
                     f"trainer;iteration_based_train;iterations={OPTION_ITERATIONS}",
                     "trainer;iteration_based_train;valid_step=1000000000",
                     "trainer;iteration_based_train;save_period=1000000000",
                     "trainer;iteration_based_train;train_log_step=1",
                     "trainer;device_rasterize=true", *OPTION_OVERRIDES]
        run = RunConfig.from_args(str(repo / "configs" / "train_esr_2x.yml"),
                                  overrides=overrides, runid="chip_smoke_options", seed=0)
        return run, Trainer(run, device=dev, train_recordings=train_recs,
                            valid_recordings=valid_recs)

    runs = {}
    for name in ("first", "again"):
        t0 = time.perf_counter()
        run, trainer = trainer_of(name)
        data = trainer.train_loader.dataset.datasets[0]
        if not (trainer.device_rasterize and data.pause_enabled and data.dataset.add_noise[
                "enabled"] and data.dataset.hot_filter is not None and trainer.k_steps == GRAPH_K):
            fail("the data options did not reach the trainer's dataset")
        if name == "first":
            cfg = run.config["train_dataloader"]["dataset"]
            raw, _ = options_batch(np, cfg, train_recs, RAW_KEYS)
            host, _ = options_batch(np, cfg, train_recs, TRAIN_KEYS)
            dense = trainer._select(raw)
            for k, hk in (("inp", "inp_scaled_cnt"), ("gt", "gt_cnt")):
                if not same_bits(torch, dense[k], torch.from_numpy(host[hk]).to(dev)):
                    fail(f"options: the device-rasterized {k} is not bitwise the host's")
            valid = raw["inp_events_valid"].sum(axis=-1)
            cap = raw["inp_events_valid"].shape[-1]
            paused = int((valid == 0).sum())
            if cap != 2048 + 204 or not paused or not (valid > 2048).any():
                fail(f"options: capacity {cap}, {paused} paused windows, most events "
                     f"{int(valid.max())}: no noise or no pause in the first batch")
            print(f"options: the first B=32 batch rasterized on the card bitwise the host's "
                  f"count images; capacity {cap} rows a window (2048 + 204 noise), "
                  f"{paused} of {valid.size} windows paused, the rest {int(valid[valid > 0].min())}"
                  f"-{int(valid.max())} events")
        rec = track_groups(torch, trainer, {GRAPH_K - 1, OPTION_ITERATIONS - 1})
        reset_all_launches()
        t1 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        graph = trainer.multi_step.graph
        launches = launch_counts()
        want = {n: (OPTION_ITERATIONS * 2 * TRAIN_WINDOWS
                    if n in ("dcn_train_fwd", "dcn_bwd", "dcn_wgrad") else 0) for n in launches}
        losses = [float(rec["losses"][i][-1]) for i in range(OPTION_ITERATIONS)]
        if launches != want or graph is None or graph.replays != 1:
            fail(f"options run {name}: launches {launches} (want {want}), graph "
                 f"{graph and graph.replays} replays")
        if not all(math.isfinite(v) for v in losses):
            fail(f"options run {name}: non-finite losses {losses}")
        runs[name] = {"rec": rec, "save_dir": run.save_dir}
        print(f"options run {name}: {OPTION_ITERATIONS} iterations in {wall:.3f} s (the second "
              f"group one replay), built in {t1 - t0:.3f} s; launches {launches}; losses "
              f"{[round(v, 6) for v in losses]}")
        del trainer
        torch.cuda.empty_cache()
    a, b = runs["first"]["rec"], runs["again"]["rec"]
    if not all(same_bits(torch, a["losses"][i][-1], b["losses"][i][-1])
               for i in range(OPTION_ITERATIONS)):
        fail("options: the two runs' losses differ")
    for it in (GRAPH_K - 1, OPTION_ITERATIONS - 1):
        if not same_state(torch, a["state"][it][-1], b["state"][it][-1]):
            fail(f"options: the two runs' parameters or moments differ after iteration {it}")
    print(f"options: the two runs bitwise equal ({OPTION_ITERATIONS} losses; parameters and "
          f"Adam's moments after iterations {GRAPH_K - 1} and {OPTION_ITERATIONS - 1})")

    off = copy.deepcopy(cfg)
    off["add_noise"] = {"enabled": False}
    off["hot_filter"] = {"enabled": False}
    off["sequence"]["pause"]["enabled"] = False
    times = {}
    NE.ROUTES.reset()
    for label, dcfg in (("off", off), ("on", cfg), ("on", cfg), ("off", off)):
        times.setdefault(label, []).append(options_batch(np, dcfg, train_recs, TRAIN_KEYS, 2)[1])
    print(f"options batch build on the host of {card}: B=32 native, no workers, ms a batch "
          f"(mean of 2 after a first, in turns off/on/on/off) with the options "
          f"{', '.join(f'{t:.3f}' for t in times['on'])} against without "
          f"{', '.join(f'{t:.3f}' for t in times['off'])} "
          f"({sum(times['on']) / sum(times['off']):.3f}x); routes {NE.ROUTES.snapshot()}")
    ckpt = find_latest_checkpoint(os.path.dirname(runs["first"]["save_dir"]))
    if ckpt is None:
        fail("options: the run committed no final checkpoint")
    return ckpt


def lpips_evaluation(torch, np, dev, card, ckpt: str, out_root: str) -> None:
    """The options run's checkpoint through ``run_inference`` (what ``infer
    --no_engine`` calls; the recording stays in memory) with
    ``--allow_uncalibrated_lpips`` and with ``--lpips_backbone`` from a
    seeded alex npz: each report holds ``esr_lpips`` and ``bicubic_lpips``,
    and every window's two values are within 1e-4 relative of the same
    LPIPS on the CPU over the same images; the harness's per-window p50
    with LPIPS and without it, and LPIPS's device ms a window."""
    from torch.profiler import ProfilerActivity, profile

    from esr_tpu_torch.config.parser import loads
    from esr_tpu_torch.data.synthetic import make_synthetic_recording
    from esr_tpu_torch.inference.harness import InferenceRunner, run_inference
    from esr_tpu_torch.losses import lpips as L

    recording = make_synthetic_recording((720, 1280), base_events=80_000, num_frames=2,
                                         rungs=("down8", "down16"), seed=0)
    eval_cfg = {k: v for k, v in FLAGSHIP_DATA.items() if k != "item_keys"}
    rng = np.random.default_rng(16)
    npz = os.path.join(out_root, "lpips_alex.npz")
    np.savez(npz, **{f"{prefix}.{part}": (
        rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:])) if part == "weight"
        else rng.uniform(-0.1, 0.1, shape[0])).astype(np.float32)
        for prefix, shape in L.backbone_layout("alex") for part in ("weight", "bias")})
    # what run_inference builds from each way's arguments
    ways = {"uncalibrated": ({"allow_uncalibrated_lpips": True}, {"allow_uncalibrated": True}),
            "backbone": ({"lpips_backbone_npz": npz},
                         {"backbone_state": L.load_backbone_npz(npz)}),
            "none": ({}, None)}

    def evaluate(name):
        pairs, starts = [], []
        multi_channel, forward = L.LPIPS.multi_channel, InferenceRunner.forward

        def recorded(self, pred, tgt):
            out = multi_channel(self, pred, tgt)
            pairs.append((out.detach(), pred.detach().clone(), tgt.detach().clone()))
            return out

        def timed(self, inp, states):
            starts.append(time.perf_counter())
            return forward(self, inp, states)

        L.LPIPS.multi_channel, InferenceRunner.forward = recorded, timed
        out = os.path.join(out_root, f"lpips_{name}")
        try:
            mean = run_inference(ckpt, [recording], out, eval_cfg, engine=False, device=dev,
                                 **ways[name][0])
            torch.cuda.synchronize()
            starts.append(time.perf_counter())
        finally:
            L.LPIPS.multi_channel, InferenceRunner.forward = multi_channel, forward
        with open(os.path.join(out, recording.name, "inference.yml")) as f:
            report = loads(f.read())["evaluation results"]
        has = [k for k in ("esr_lpips", "bicubic_lpips") if k in report]
        if has != (["esr_lpips", "bicubic_lpips"] if name != "none" else []) or not all(
                math.isfinite(v) for v in report.values()):
            fail(f"lpips {name}: the report holds {has}: {report}")
        walls = sorted(np.diff(starts) * 1e3)
        return pairs, report, walls[len(walls) // 2]

    p50 = {}
    for name in ("uncalibrated", "backbone"):
        pairs, report, p50[name] = evaluate(name)
        if len(pairs) != 2 * int(report["n_windows"]):
            fail(f"lpips {name}: {len(pairs)} distances for {report['n_windows']} windows")
        cpu = L.build_lpips(L.load_lpips_params(**ways[name][1]), "alex", "cpu")
        with torch.no_grad():
            rel = max(abs(float(v) - float(cpu.multi_channel(p.cpu(), t.cpu())))
                      / max(abs(float(v)), TINY) for v, p, t in pairs)
        print(f"lpips {name}: {int(report['n_windows'])} windows, esr_lpips "
              f"{report['esr_lpips']:.6f}, bicubic_lpips {report['bicubic_lpips']:.6f} in the "
              f"report; every window's distances within {rel:.3e} of the CPU's on the same "
              f"images (limit {LPIPS_REL})")
        if not rel <= LPIPS_REL:
            fail(f"lpips {name}: the card's per-window values differ from the CPU's by {rel:.3e}")
    _, _, p50["none"] = evaluate("none")

    lpips = L.build_lpips(L.load_lpips_params(**ways["backbone"][1]), "alex", dev)
    pred, gt = pairs[0][1], pairs[0][2]
    with torch.no_grad():
        lpips.multi_channel(pred, gt)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                lpips.multi_channel(pred, gt)
                lpips.multi_channel(pred, gt)
            torch.cuda.synchronize()
    busy = device_busy_ms(torch, prof) / 3
    print(f"lpips on {card}: the harness's per-window p50 {p50['none']:.3f} ms without LPIPS, "
          f"{p50['uncalibrated']:.3f} / {p50['backbone']:.3f} ms with it (seeded / npz "
          f"backbone); LPIPS's device time {busy:.3f} ms a window (alex, two distances of "
          f"{tuple(pred.shape)} images, f32)")


def phase_data_options(torch, np, dev, card, repo: Path, out_root: str, recs, c10) -> None:
    """Phase 8f: the flagship trained with every data option of the
    reference that the shipped configs carry, its checkpoint evaluated with
    LPIPS, and the SR recipe's card-against-CPU window repeated (C10)."""
    t_phase = time.perf_counter()
    ckpt = options_training(torch, np, dev, card, repo, out_root, recs)
    t_train = time.perf_counter()
    lpips_evaluation(torch, np, dev, card, ckpt, out_root)
    t_lpips = time.perf_counter()
    model, sel = c10
    holder = types.SimpleNamespace(model=model.to(dev))
    f64 = None
    for _ in range(C10_REPEATS):
        f64 = srunet_card_vs_cpu(torch, holder, sel, f64=f64)["f64"]
    print(f"data options and LPIPS phase {time.perf_counter() - t_phase:.1f} s (training "
          f"{t_train - t_phase:.1f} s, LPIPS {t_lpips - t_train:.1f} s, C10's window x"
          f"{C10_REPEATS} {time.perf_counter() - t_lpips:.1f} s)")


# Part of phase 8e: the SR recipe's int8 seams (hooked at B=1 on a 90x160
# window: 41 a window, 16 distinct) and K2's shapes above its staging
SR_SEAM_CALLS = 41
SR_DISTINCT_SEAMS = 16
K2_LARGE_SHAPES = ((4, 128, 96, 160), (8, 32, 180, 320), (32, 8, 96, 160), (96, 8, 96, 160))


def k2_large_shapes(torch, dev, card):
    """K2 at large shapes (the SR recipe's decoder 0 input at lanes 4 and
    its decoder 2 input at lanes 8, the flagship's head output at batch 32
    and at lanes 32): one cooperative launch, which reads x twice where a
    block's share passes its shared memory (all but the third), bitwise its
    plain version, twice; its time through the op, the C entry point and a
    CUDA graph, beside the bound (f32 read, int8 written, at 3.35 TB/s) and
    the plain version's."""
    from esr_tpu_torch.ops import int8_cuda

    lib = int8_cuda.INT8_LIBRARY.load()
    rows = []
    for shape in K2_LARGE_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(sum(shape))
        x = torch.randn(shape, device=dev, generator=gen)
        items = int8_cuda.quantize_items(shape)
        blocks = int8_cuda.quantize_blocks(items)
        staged = items <= int8_cuda.QUANTIZE_MAX_BLOCKS * int8_cuda.QUANTIZE_ITEMS_PER_BLOCK
        runs = [int8_cuda.quantize_per_tensor(x) for _ in range(2)]
        pq, psx = int8_cuda.quantize_per_tensor_plain(x)
        torch.cuda.synchronize()
        if not all(torch.equal(q, pq) and same_bits(torch, sc, psx) for q, sc in runs):
            fail(f"quantize_per_tensor differs from its plain version (or run to run) at "
                 f"{shape}")
        op_ms = time_ms(torch, lambda: int8_cuda.quantize_per_tensor(x), iters=50)
        q_e, s_e = torch.zeros_like(pq), torch.empty_like(psx)
        b, c, h, w = shape

        def entry():
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.quantize_per_tensor_f32(
                x.data_ptr(), b, c, h * w, pq.shape[-1], q_e.data_ptr(), s_e.data_ptr(),
                int8_cuda.quantize_per_tensor.partials(dev, stream).data_ptr(), blocks, stream)
            if rc:
                fail(f"quantize_per_tensor_f32 returned {rc} at {shape}")

        entry_ms = time_ms(torch, entry, iters=50)
        q_e.zero_()
        g_ms = graph_ms(torch, entry)
        torch.cuda.synchronize()
        if not torch.equal(q_e, pq):
            fail(f"K2 replayed from a CUDA graph disagrees at {shape}")
        plain_ms = time_ms(torch, lambda: int8_cuda.quantize_per_tensor_plain(x), iters=5,
                           warmup=2)
        bound, _ = int8_roofline(4 * x.numel() + pq.numel(), 0.0)
        rows.append(dict(shape=list(shape), items=items, blocks=blocks, staged=staged,
                         ms=op_ms, entry_ms=entry_ms, graph_ms=g_ms, plain_ms=plain_ms,
                         bound_ms=bound))
        print(f"K2 large {list(shape)} ({items} items, a cooperative grid of {blocks} blocks, "
              f"{'x staged' if staged else 'x read twice'}) on {card}: op {op_ms:.5f} / entry "
              f"{entry_ms:.5f} / graph "
              f"{g_ms:.5f} ms, bound {bound:.6f} ms (bytes), plain {plain_ms:.5f} ms; bitwise "
              "the plain version, twice and replayed")
    return rows


def srunet_rung_serving(torch, np, dev, card, model, evals):
    """The SR recipe served at each rung on one replica: lanes 4, the
    serving traffic (``standard:8``, ``gated:4:0.3``, 8 streams at 8/s),
    preemption quantum 2. Every request done, at each rung within 1.0 dB of
    its f32 twin; no DCN launch, K1 and K2 once a seam a window step at
    int8 only; windows/s and p50/p99 per class; a window's device ms through
    the harness at each rung."""
    from esr_tpu_torch.inference.harness import InferenceRunner
    from esr_tpu_torch.ops import int8_cuda
    from esr_tpu_torch.serving.server import ServingEngine

    classes, streams, schedule = serving_traffic()
    out = {}
    for rung in RUNGS:
        def server(**kw):
            return ServingEngine(model, SERVE_DATA, lanes=LANES, classes=classes,
                                 default_class="standard", precision=rung,
                                 activity_tile=SERVE_ACTIVITY_TILE, device=dev, **kw)

        server(preempt_quantum=0).run(schedule[:1])  # warm
        srv = server(preempt_quantum=2)
        reset_all_launches()
        summary = srv.run(schedule, max_wall_s=600)
        torch.cuda.synchronize()
        k12 = {k.name: k.launches for k in int8_cuda.KERNELS}
        want = SR_SEAM_CALLS * summary["window_steps"] if rung == "int8" else 0
        if any(counts_of().values()) or any(v != want for v in k12.values()):
            fail(f"srunet serving {rung} launched {counts_of()} / {k12}: no DCN, and K1 and "
                 f"K2 {want} each expected")
        reports = srv.reports()
        if summary["completed"] != len(streams) or any(
                r["status"] != "ok" for r in reports.values()):
            fail(f"srunet serving {rung}: not every request ended done ({summary['statuses']})")
        out[rung] = reports
        cls = {n: (c["p50_window_ms"], c["p99_window_ms"]) for n, c in summary["classes"].items()}
        print(f"srunet serving {rung} on {card}: {summary['windows_per_sec']} windows/s "
              f"computed, {summary['served_windows_per_sec']} served, "
              f"{summary['preemptions']} preemptions, {summary['window_steps']} window steps; "
              f"window (p50, p99) ms by class {cls}; launches K1/K2 {k12} "
              f"({SR_SEAM_CALLS if rung == 'int8' else 0} each a window step)")
    for rung in ("bf16", "int8"):
        diffs = {rid: r["esr_psnr"] - out["f32"][rid]["esr_psnr"]
                 for rid, r in out[rung].items() if r["n_windows"]}
        worst = max(diffs.values(), key=abs)
        print(f"srunet serving {rung}: {len(diffs)} requests' ESR PSNR against f32, the "
              f"farthest {worst:+.5f} dB (limit {PSNR_DROP_DB})")
        if not all(abs(d) <= PSNR_DROP_DB for d in diffs.values()):
            fail(f"srunet serving at {rung}: a request is farther than {PSNR_DROP_DB} dB "
                 "from f32")
    for rung in RUNGS:
        runner = InferenceRunner(model, 3, device=dev, precision=rung)
        reset_all_launches()
        busy, named = rung_window_profile(torch, runner, evals[0], dev, card)
        launched = {k.name: k.launches for k in int8_cuda.KERNELS}
        want = 2 * SR_SEAM_CALLS if rung == "int8" else 0  # a warm window, then the profiled
        print(f"srunet window device time {rung} on {card}: {busy:.4f} ms a window (B=1, "
              f"the harness); K1/K2 launched {launched} in 2 windows, the profiler saw "
              f"{named['int8_igemm_kernel'][1]} K1 and {named['quantize_kernel'][1]} K2 in "
              "the profiled one")
        if any(v != want for v in launched.values()):
            fail(f"srunet harness {rung}: K1/K2 launched {launched}, {want} each expected")


def srunet_int8_engine(torch, dev, card, model, evals):
    """The int8 engine at lanes 4 x chunk 8 over the evaluation recordings
    (its chunk a CUDA graph on the card), against the f32 engine: every
    recording within 1.0 dB; K1 and K2 once a seam a window step, among
    them the seams past K2's staging (its large path)."""
    from esr_tpu_torch.data.loader import InferenceSequenceLoader
    from esr_tpu_torch.inference.engine import StreamingEngine
    from esr_tpu_torch.ops import int8_cuda

    kh, kw = InferenceSequenceLoader(evals[0], FLAGSHIP_DATA).gt_resolution
    cap = int8_cuda.QUANTIZE_MAX_BLOCKS * int8_cuda.QUANTIZE_ITEMS_PER_BLOCK
    big = [shape for _, shape, *_ in int8_seam_calls(torch, model, dev, LANES, kh, kw)
           if int8_cuda.quantize_items(shape) > cap]
    if not big:
        fail("no SR seam at lanes 4 takes K2's large path")
    results = {}
    for rung in ("f32", "int8"):
        engine = StreamingEngine(model, 3, lanes=LANES, chunk_windows=CHUNK_WINDOWS,
                                 precision=rung, device=dev)
        engine.run_datalist(evals[:2], FLAGSHIP_DATA)  # warm and capture
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        res, _ = engine.run_datalist(evals, FLAGSHIP_DATA)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = CHUNK_WINDOWS * len(engine.chunk_seconds)
        k12 = {k.name: k.launches for k in int8_cuda.KERNELS}
        want = SR_SEAM_CALLS * steps if rung == "int8" else 0
        if any(counts_of().values()) or any(v != want for v in k12.values()):
            fail(f"the SR {rung} engine launched {counts_of()} / {k12} ({want} K1/K2 expected)")
        results[rung] = res
        n = int(sum(r["n_windows"] for r in res))
        print(f"srunet engine {rung} on {card} (lanes {LANES} x chunk {CHUNK_WINDOWS}): {n} "
              f"windows in {wall:.3f} s, {n / wall:.3f} windows/s; K1/K2 {k12}"
              + (f"; {len(big)} seams a window step past K2's staging: "
                 f"{sorted(set(big))}" if rung == "int8" else ""))
    worst = max((f["esr_psnr"] - r["esr_psnr"] for f, r in zip(results["f32"],
                                                                results["int8"])), key=abs)
    print(f"srunet engine int8: the farthest recording's ESR PSNR against f32 {worst:+.5f} dB")
    if not abs(worst) <= PSNR_DROP_DB:
        fail(f"the SR int8 engine is {worst:.3f} dB from f32")


def phase_srunet_serving(torch, np, dev, card, repo: Path, out_dir: str, ckpt: str, evals,
                         artifacts) -> dict:
    """Phase 8e: the SR recipe's checkpoint from phase 8d (full width) at
    serving, the fleet, AOT and the bf16 and int8 rungs. K1 and K2 bitwise
    their plain versions at the recipe's 16 seams at lanes 1 and 4 (5x5
    taps among them) and K2 at :data:`K2_LARGE_SHAPES`; served at each rung
    (:func:`srunet_rung_serving`); the int8 engine at lanes 4
    (:func:`srunet_int8_engine`); the fleet at f32, 3 replicas x 4 lanes
    under ``build_fleet_plan(0)`` (a forced handoff, a kill, a partition):
    zero lost, every stream within 1e-5 of its one-replica twin; and the
    depth-8 artifacts of phase 10c at f32 and int8, loaded with the trained
    weights, bitwise the traced sessions. Returns the kernels' rows."""
    from esr_tpu_torch.inference.checkpoint import load_checkpoint
    from esr_tpu_torch.resilience.chaos_fleet import N_REPLICAS, run_fleet_scenario

    t_phase = time.perf_counter()
    model, _ = load_checkpoint(ckpt)
    model = model.to(dev).eval()
    kh, kw = 90, 160
    seams = int8_seam_calls(torch, model, dev, 1, kh, kw)
    distinct = {c[1:] for c in seams}
    print(f"srunet int8 seams: {len(seams)} a window, {len(distinct)} distinct (B=1, "
          f"{kh}x{kw})")
    if (len(seams), len(distinct)) != (SR_SEAM_CALLS, SR_DISTINCT_SEAMS):
        fail(f"the SR recipe has {len(seams)} int8 seams a window ({len(distinct)} distinct), "
             f"expected {SR_SEAM_CALLS} ({SR_DISTINCT_SEAMS})")
    shapes = int8_kernel_shapes(torch, np, dev, card, model, kh, kw)
    k2_rows = k2_large_shapes(torch, dev, card)
    print(f"srunet kernels: {time.perf_counter() - t_phase:.1f} s")

    srunet_rung_serving(torch, np, dev, card, model, evals)
    srunet_int8_engine(torch, dev, card, model, evals)
    print(f"srunet rungs: {time.perf_counter() - t_phase:.1f} s")

    classes, streams, schedule = serving_traffic()
    reset_all_launches()
    t0 = time.perf_counter()
    result = run_fleet_scenario(os.path.join(out_dir, "fleet"), model, streams, SERVE_DATA,
                                classes, seed=0, lanes=LANES,
                                activity_tile=SERVE_ACTIVITY_TILE, device=dev)
    torch.cuda.synchronize()
    summary, twin = result["summary"], result["twin_summary"]
    print(f"srunet fleet: {N_REPLICAS} replicas x {LANES} lanes at f32, {len(streams)} streams, "
          f"{time.perf_counter() - t0:.2f} s; statuses {summary['statuses']}, zero lost "
          f"{summary['zero_lost']}; checks {json.dumps(result['checks'])}")
    print(f"srunet fleet vs twin: worst relative metric difference "
          f"{result['parity']['max_rel_diff']:.3e} over {result['parity']['compared']} streams "
          f"(limit 1e-5), window counts equal {result['parity']['windows_match']}; handoffs "
          f"{summary['migrations']}, fail-overs {summary['failovers']}; "
          f"{summary['windows_per_sec']} windows/s against the twin's "
          f"{twin['windows_per_sec']} on {card}")
    for name, c in result["classes"].items():
        print(f"srunet fleet class {name} on {card}: window latency p50 "
              f"{c['window_latency_p50_ms']} ms, p99 {c['window_latency_p99_ms']} ms over "
              f"{c['windows']} windows")
    if not result["ok"] or not summary["zero_lost"] or any(counts_of().values()):
        fail("the SR fleet failed: " + json.dumps(
            {k: v for k, v in result["checks"].items() if not v}))
    del result

    for rung in SR_AOT_RUNGS:
        a_sum, counts, loads = aot_vs_traced(torch, model, dev, card, rung, artifacts[rung],
                                             classes, schedule, "srunet")
        want = SR_SEAM_CALLS * a_sum["window_steps"] if rung == "int8" else 0
        if any(counts[k] for k in counts_of()) or (counts["int8_conv"],
                                                    counts["quantize_per_tensor"]) != (want,
                                                                                       want):
            fail(f"aot srunet {rung}: launches {counts}, K1/K2 {want} each expected")
        print(f"aot srunet {rung}: the artifact loaded with the trained weights in "
              f"{[round(v * 1e3, 1) for v in loads.values()]} ms")
    print(f"srunet serving phase {time.perf_counter() - t_phase:.1f} s")
    return {"shapes": shapes, "k2_large": k2_rows}


def step_kernel_vs_plain(torch, trainer, sel, what: str = "step") -> None:
    """One step from the trainer's params on batch ``sel`` through the
    kernels and through the plain path: the per-window losses and every
    parameter's grad within 1e-3 of their own scale (max |plain|)."""
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.training.train_step import window_losses

    losses, grads = {}, {}
    for path in ("kernel", "plain"):
        model = copy.deepcopy(trainer.model).train()
        model.spacetime_fuse.dcn_impl = "auto" if path == "kernel" else "plain"
        dcn_cuda.reset_launches()
        per_window, _ = window_losses(model, sel, trainer.seqn)
        per_window.sum().backward()
        torch.cuda.synchronize()
        launched = sum(k.launches for k in dcn_cuda.KERNELS)
        if (launched == 0) != (path == "plain"):
            fail(f"the {path} path launched {launched} DCN kernels")
        losses[path] = per_window.detach()
        grads[path] = {n: p.grad for n, p in model.named_parameters()}
        del model
    err, scale, limit = rel_err_of(torch, losses["kernel"], losses["plain"])
    print(f"{what} kernel vs plain: loss_per_window max_abs_err {err:.3e} "
          f"(scale {scale:.3e}, limit {limit:.3e})")
    if not err <= limit:
        fail(f"the kernel path's losses differ from the plain path's ({what})")
    # every parameter's grad, each against its own scale
    rows = sorted(((e / max(s, TINY), n, e, s, lim) for n, ref in grads["plain"].items()
                   for e, s, lim in [rel_err_of(torch, grads["kernel"][n], ref)]),
                  reverse=True)
    print(f"{what} kernel vs plain grads: {len(rows)} parameters; worst err/scale "
          + "; ".join(f"{n} {e:.3e}/{s:.3e} = {r:.3e}" for r, n, e, s, _ in rows[:5]))
    print(f"{what} kernel vs plain grads, DCN params: " + "; ".join(
        f"{n} {e:.3e}/{s:.3e} = {r:.3e}" for r, n, e, s, _ in rows
        if n.startswith(("spacetime_fuse.dcn_weight", "spacetime_fuse.dcn_bias",
                         "spacetime_fuse.dcn_offset_mask"))))
    bad = [n for _, n, e, _, lim in rows if not e <= lim]
    if bad:
        fail(f"the kernel path's grads differ from the plain path's beyond "
             f"{TOL} of their own scale ({what}): {bad}")


def checkpoint_ways(torch, trainer, ckpt: str, root: str, card: str) -> None:
    """The flagship's asynchronous checkpoint against the sync path on the
    B=32 run's final state. The run's own last checkpoint (``ckpt``,
    committed on the writer thread) against a sync save of the same state
    at the same iteration: the same ``digest.json`` and ``meta.json``, and
    the restored parameters and optimizer state bitwise. Then the seconds a
    save blocks the loop, sync against async, in turns (sync, async,
    async, sync), beside each async commit's seconds."""
    import numpy as np

    from esr_tpu_torch.training.async_checkpoint import AsyncCheckpointer
    from esr_tpu_torch.training.checkpoint import read_meta, restore_state, save_checkpoint

    if trainer._async_ckpt is None or trainer._async_ckpt.commits < 1:
        fail("the flagship's async_checkpoint: true did not commit on the writer")
    iteration = read_meta(ckpt)["trainer"]["iteration"]
    args = (trainer.model, trainer.optimizer, trainer.run.config)
    sync_dir = os.path.join(root, "sync_final")
    save_checkpoint(sync_dir, *args, iteration, trainer.mnt_best)
    sync_ckpt = os.path.join(sync_dir, f"checkpoint-iteration{iteration}")
    for name in ("digest.json", "meta.json"):
        if Path(ckpt, name).read_bytes() != Path(sync_ckpt, name).read_bytes():
            fail(f"the async checkpoint's {name} differs from the sync one's")
    got, want = restore_state(ckpt), restore_state(sync_ckpt)
    if sorted(got) != sorted(want) or not all(
            np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes() for k in want):
        fail("the async checkpoint's restored state is not bitwise the sync one's")
    state_bytes = sum(np.asarray(v).nbytes for v in want.values())
    ck = AsyncCheckpointer(trainer.commit_retries, trainer.commit_backoff_s)
    blocked, commits = {"sync": [], "async": []}, []
    for i, way in enumerate(("sync", "async", "async", "sync")):
        where = os.path.join(root, f"turn{i}")
        torch.cuda.synchronize()
        if way == "sync":
            t0 = time.perf_counter()
            save_checkpoint(where, *args, iteration, trainer.mnt_best)
            blocked[way].append(time.perf_counter() - t0)
        else:
            blocked[way].append(ck.save(where, *args, iteration, trainer.mnt_best))
            ck.wait()
            commits.append(ck.last_commit_s)
    print(f"checkpoint {Path(ckpt).name} (async, the run's): digest.json and meta.json the "
          f"sync save's, restored params and optimizer state ({len(want)} arrays, "
          f"{state_bytes} bytes) bitwise")
    print(f"checkpoint blocked ms a save on {card} (B=32 flagship state, {state_bytes} bytes; "
          f"turns sync, async, async, sync): sync "
          f"{', '.join(f'{t * 1e3:.3f}' for t in blocked['sync'])}; async snapshot "
          f"{', '.join(f'{t * 1e3:.3f}' for t in blocked['async'])}; async commit on the "
          f"writer {', '.join(f'{t * 1e3:.3f}' for t in commits)}")


def phase_train_4x(torch, np, dev, card, repo: Path, out_root: str, fwd_b8: dict,
                   train_b8: dict):
    """Phase 7c: ``configs/train_esr_4x.yml`` as written (batch 8, its
    async checkpoint, vis and tensorboard on), overriding only the run's
    length and paths, on in-memory 720x1280 recordings with a down4 GT
    stream: 3 steps and one validation. Each step launches ``dcn_train_fwd``,
    ``dcn_bwd`` and ``dcn_wgrad`` 14 times (the 24x40 bottleneck), the
    validation only ``dcn_fwd``; a committed final checkpoint; one step's
    losses and grads against the plain path within 1e-3 of their scale; the
    step's time and device busy time beside the kernels' times and bounds
    at that shape (``fwd_b8``, ``train_b8``, from phases 3 and 4). Returns
    the run's launches."""
    from torch.profiler import ProfilerActivity, profile

    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.data.loader import collate_sequences
    from esr_tpu_torch.data.synthetic import make_synthetic_recording
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.training.checkpoint import find_latest_checkpoint
    from esr_tpu_torch.training.trainer import Trainer

    def rec(events, seed):
        return make_synthetic_recording((720, 1280), base_events=events, num_frames=2,
                                        rungs=("down4", "down16"), seed=seed)

    t0 = time.perf_counter()
    train_recs, valid_recs = [rec(300_000, 30)], [rec(40_000, 31)]
    print(f"train 4x setup: recordings in {time.perf_counter() - t0:.2f} s")
    overrides = [
        f"trainer;output_path={out_root}",
        "trainer;iteration_based_train;iterations=3",
        "trainer;iteration_based_train;valid_step=2",
        "trainer;iteration_based_train;train_log_step=1",
    ]
    run = RunConfig.from_args(str(repo / "configs" / "train_esr_4x.yml"),
                              overrides=overrides, runid="chip_smoke_4x", seed=0)
    trainer = Trainer(run, device=dev, train_recordings=train_recs,
                      valid_recordings=valid_recs)
    batch_size = run.config["train_dataloader"]["batch_size"]
    if len(trainer.train_loader) < trainer.iterations or trainer._async_ckpt is None:
        fail("the 4x run holds fewer batches than iterations, or saves synchronously")
    per_step, per_valid, step_ms = [], [], []
    train_step, valid = trainer.train_step, trainer._valid

    def counted_step(batch):
        before = counts_of()
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({n: c - before[n] for n, c in counts_of().items()})
        return metrics

    def counted_valid():
        before = counts_of()
        result = valid()
        per_valid.append({n: c - before[n] for n, c in counts_of().items()})
        return result

    trainer.train_step, trainer._valid = counted_step, counted_valid
    dcn_cuda.reset_launches()
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = counts_of()
    trainer.train_step, trainer._valid = train_step, valid
    want_step = {"dcn_fwd": 0, "dcn_train_fwd": 2 * TRAIN_WINDOWS,
                 "dcn_bwd": 2 * TRAIN_WINDOWS, "dcn_wgrad": 2 * TRAIN_WINDOWS,
                 "dcn_fwd_masked": 0, "dcn_train_fwd_masked": 0}
    want_valid = only("dcn_fwd", 2 * len(trainer.valid_loader) * TRAIN_WINDOWS)
    print(f"train 4x: {len(per_step)} steps of batch {batch_size} + {len(per_valid)} "
          f"validation(s) in {wall:.3f} s; result {json.dumps(result)}; launches per step "
          f"{per_step}; per validation {per_valid}")
    if len(per_step) != trainer.iterations or any(c != want_step for c in per_step):
        fail(f"4x train steps launched {per_step}, each should be {want_step}")
    if per_valid != [want_valid]:
        fail(f"the 4x validation launched {per_valid}, should be [{want_valid}]")
    if not all(math.isfinite(v) for v in result.values()):
        fail(f"the 4x run's losses are not finite: {result}")
    ckpt = find_latest_checkpoint(os.path.dirname(run.save_dir))
    if ckpt is None or not ckpt.endswith(f"checkpoint-iteration{trainer.iterations - 1}"):
        fail(f"the 4x run committed no final checkpoint (found {ckpt})")
    dataset = trainer.train_loader.dataset
    sel = trainer._select(collate_sequences([dataset.get_item(i, seed=i)
                                             for i in range(batch_size)]))
    print(f"train 4x batch: inp {tuple(sel['inp'].shape)}, gt {tuple(sel['gt'].shape)}")
    step_kernel_vs_plain(torch, trainer, sel, what="4x step")
    train_step(sel)  # warm
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(sel)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(sel)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    print(f"train 4x step on {card}: batch {batch_size}, step (host clock to synchronize) "
          f"{sorted(times)[1]:.3f} ms median of 3 ({', '.join(f'{t:.3f}' for t in times)}); "
          f"in the run {', '.join(f'{t:.3f}' for t in step_ms)} ms")
    busy = device_time_breakdown(torch, prof, 1, prof_ms, "4x train step", card)
    rows = [("dcn_fwd (validation, B=8)", fwd_b8)] + [
        (f"{k} (B=8)", train_b8[k]) for k in ("dcn_train_fwd", "dcn_bwd", "dcn_wgrad")]
    print(f"train 4x kernels at 24x40x64 on {card}: " + "; ".join(
        f"{name} {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms "
        f"({r['bound_by']}), max_abs_err {r['err']:.3e}" for name, r in rows)
        + f"; 14 launches a step each of the train kernels: "
        f"{sum(train_b8[k]['ms'] for k in ('dcn_train_fwd', 'dcn_bwd', 'dcn_wgrad')) * 14:.3f} "
        f"ms of the step's " + ("device busy not measured" if busy is None
                                else f"{busy:.3f} ms device busy"))
    return {k: totals[k] for k in ("dcn_fwd", "dcn_train_fwd", "dcn_bwd", "dcn_wgrad")}


def step_ways(torch, trainer, sel, card):
    """Two B=32 steps from the trainer's state each way: probes off against
    on, remat off against on. Losses, every gradient and every updated
    parameter bitwise the plain step's, or fail; a third step's device busy
    time (the profiler), the second step's CUDA-event span, peak memory
    (``max_memory_allocated``) and the ``dcn_train_fwd`` launches of a step,
    printed."""
    from torch.profiler import ProfilerActivity, profile

    from esr_tpu_torch.training.train_step import make_train_step

    out = {}
    for name, kw in (("plain", {}), ("probes", {"numerics": True}), ("remat", {"remat": True})):
        model, opt = copy.deepcopy((trainer.model, trainer.optimizer))
        model.numerics = model.spacetime_fuse.numerics = name == "probes"
        step = make_train_step(model, opt, trainer.seqn, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs, ms, launches = [], [], []
        for _ in range(2):
            before = counts_of()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(sel)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            launches.append(counts_of()["dcn_train_fwd"] - before["dcn_train_fwd"])
            runs.append((metrics["loss_per_window"].clone(),
                         {n: p.grad.clone() for n, p in model.named_parameters()}))
        peak = torch.cuda.max_memory_allocated() - base
        # a third step under the profiler: the card's busy time, without the
        # host's gaps that the events' span holds
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(sel)
            torch.cuda.synchronize()
        out[name] = {"runs": runs, "ms": ms, "launches": launches, "peak": peak,
                     "busy": device_busy_ms(torch, prof),
                     "params": {n: p.detach().clone() for n, p in model.named_parameters()},
                     "numerics": metrics.get("numerics")}
        del model, opt, step
    plain = out["plain"]
    for name in ("probes", "remat"):
        o = out[name]
        bad = [f"step {i} losses" for i in range(2)
               if not same_bits(torch, o["runs"][i][0], plain["runs"][i][0])]
        bad += [f"step {i} grad {n}" for i in range(2) for n in plain["runs"][i][1]
                if not same_bits(torch, o["runs"][i][1][n], plain["runs"][i][1][n])]
        bad += [f"param {n}" for n in plain["params"]
                if not same_bits(torch, o["params"][n], plain["params"][n])]
        print(f"B=32 steps, {name} on vs off: losses, {len(plain['params'])} grads a step and "
              f"the updated params {'bitwise' if not bad else 'DIFFER'}")
        if bad:
            fail(f"the {name} steps are not bitwise the plain steps: {bad[:8]}")
    want = {"plain": 2 * TRAIN_WINDOWS, "probes": 2 * TRAIN_WINDOWS,
            "remat": 4 * TRAIN_WINDOWS}
    for name, o in out.items():
        if o["launches"] != [want[name]] * 2:
            fail(f"the {name} step launched dcn_train_fwd {o['launches']}, should be "
                 f"{want[name]} a step")
    tags = out["probes"]["numerics"]
    if len(tags) != 15:
        fail(f"the probed step read back {sorted(tags)}")
    print(f"B=32 flagship steps on {card}: " + "; ".join(
        f"{name} device busy {o['busy']:.3f} ms a step (profiler), CUDA-event span "
        f"{o['ms'][1]:.3f} ms (first {o['ms'][0]:.3f}; host gaps included), peak "
        f"{o['peak'] / 2**30:.3f} GiB above the state, dcn_train_fwd {o['launches'][1]} a step"
        for name, o in out.items()))
    return {name: {"busy_ms": o["busy"], "span_ms": o["ms"][1], "peak_bytes": o["peak"]}
            for name, o in out.items()}


def transfer_bf16_step(torch, trainer, batch, repo: Path, overrides, card, recs):
    """``transfer_dtype: bf16``: the batch's host->device bytes at bf16 and
    f32, and one step from the same state on each: the loss within bf16
    rounding (2**-8 relative) of the f32 step's."""
    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.training.train_step import make_train_step
    from esr_tpu_torch.training.trainer import Trainer

    run = RunConfig.from_args(str(repo / "configs" / "train_esr_2x.yml"),
                              overrides=overrides + ["trainer;transfer_dtype=bf16"],
                              runid="chip_smoke_bf16_transfer", seed=0)
    t16 = Trainer(run, device=trainer.device, train_recordings=recs[0],
                  valid_recordings=recs[1])
    if t16.transfer_dtype != torch.bfloat16:
        fail("trainer;transfer_dtype=bf16 did not reach the trainer")
    host16 = t16._host_select(batch, for_train=True)
    host32 = trainer._host_select(batch, for_train=True)
    b16 = sum(v.numel() * v.element_size() for v in host16.values())
    b32 = sum(v.numel() * v.element_size() for v in host32.values())
    losses = {}
    for name, tr in (("bf16", t16), ("f32", trainer)):
        model, opt = copy.deepcopy((trainer.model, trainer.optimizer))
        staged = tr._stage(batch, for_train=True)
        if staged["inp"].dtype != torch.float32:
            fail(f"the {name} transfer reached the step as {staged['inp'].dtype}")
        losses[name] = float(make_train_step(model, opt, trainer.seqn)(staged)["loss"])
    if t16._stage(batch)["inp"].dtype != torch.float32 or not torch.equal(
            t16._stage(batch)["gt"], trainer._stage(batch)["gt"]):
        fail("a validation batch under transfer_dtype: bf16 is not the f32 batch")
    t16.sink.close()
    rel = abs(losses["bf16"] - losses["f32"]) / max(abs(losses["f32"]), TINY)
    print(f"transfer_dtype bf16 on {card}: host->device {b16} bytes a batch against {b32} at "
          f"f32 ({b16 / b32:.3f}); loss {losses['bf16']!r} vs {losses['f32']!r}, relative "
          f"{rel:.3e} (limit 2**-8){' (bitwise)' if losses['bf16'] == losses['f32'] else ''}")
    if not rel <= 2.0 ** -8:
        fail("the bf16-transferred step's loss is not within bf16 rounding of the f32 step's")


def phase_train_runtime(torch, np, dev, card, repo: Path, out_root: str, recs):
    """Phase 7b: the trainer's runtime at the flagship width
    (``configs/train_esr_2x.yml``, basech 8, B = 32, the train phase's
    recordings): one short run (``k_steps: 1``: one attribution record a
    step) with telemetry, probes, the live plane on an
    ephemeral port, a 2-step profile and the anomaly guard on, ``/metrics``
    and ``/healthz`` read mid-run, the telemetry reported and exported
    through ``python -m esr_tpu_torch.obs``; the probes and remat steps
    bitwise the plain ones; the chaos scenario at basech 8 on the card; the
    bf16 transfer."""
    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.data.loader import collate_sequences
    from esr_tpu_torch.obs.report import read_telemetry, report_file
    from esr_tpu_torch.resilience import chaos
    from esr_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    overrides = [
        f"trainer;output_path={out_root}",
        "trainer;iteration_based_train;iterations=4",
        "trainer;iteration_based_train;valid_step=2",
        "trainer;iteration_based_train;save_period=2",
        "trainer;iteration_based_train;train_log_step=1",
    ]
    run = RunConfig.from_args(
        str(repo / "configs" / "train_esr_2x.yml"),
        overrides=overrides + ["trainer;numerics=true", "trainer;live_telemetry=0",
                               "trainer;profile_steps=2", "trainer;max_bad_steps=1",
                               "trainer;k_steps=1"],
        runid="chip_smoke_runtime", seed=0)
    trainer = Trainer(run, device=dev, train_recordings=recs[0], valid_recordings=recs[1])
    step, scraped = trainer.train_step, {}

    def scraping_step(batch):
        if len(scraped) == 0 and trainer.optimizer.count == 2:
            base = f"http://127.0.0.1:{trainer.live_plane.port}"
            for path in ("/metrics", "/healthz"):
                scraped[path] = http_get(base + path)
        return step(batch)

    trainer.train_step = scraping_step
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trainer.train_step = step
    for path, (status, body, ms) in scraped.items():
        print(f"train live plane {path} mid-run: {status} in {ms:.3f} ms")
        if status != 200:
            fail(f"the trainer's live plane {path} answered {status} mid-run: {body[:300]}")
    if "/metrics" not in scraped or "esr_numerics_finite_frac" not in scraped["/metrics"][1]:
        fail("/metrics was not read mid-run, or carries no numerics family")
    tel = os.path.join(run.log_dir, "telemetry.jsonl")
    _, records, torn = read_telemetry(tel)
    by_type = {}
    for r in records:
        by_type.setdefault(r["type"], []).append(r)
    attribution = by_type.get("attribution", [])
    spans = {r["name"] for r in by_type.get("span", [])}
    events = {r["name"]: r for r in by_type.get("event", [])}
    gauges = {r["name"] for r in by_type.get("gauge", [])}
    tags = {r["name"] for r in by_type.get("numerics", [])}
    want_spans = {"train_run", "super_step", "data_wait", "dispatch", "device_step",
                  "metric_readback", "checkpoint", "validate", "stage_megabatch"}
    problems = []
    if [a["first_iteration"] for a in attribution] != [0, 1, 2, 3]:
        problems.append(f"attribution records {[a['first_iteration'] for a in attribution]}")
    if not want_spans <= spans:
        problems.append(f"spans missing {sorted(want_spans - spans)}")
    if len(tags) != 15 or any(r["finite_frac"] != 1.0 for r in by_type.get("numerics", [])):
        problems.append(f"numerics tags {sorted(tags)}")
    if not {"device_mem_bytes_in_use", "device_mem_peak_bytes"} <= gauges:
        problems.append(f"no watermark gauges ({sorted(gauges)})")
    for name in ("live_telemetry", "profiler_capture", "prefetch_close", "train_end"):
        if name not in events:
            problems.append(f"no {name} event")
    if torn or problems or not all(math.isfinite(v) for v in result.values()):
        fail(f"the runtime run's telemetry: {problems}; torn {torn}; result {result}")
    dev_ms = sorted(a["device_step_s"] * 1e3 for a in attribution[1:])
    print(f"train runtime run on {card}: {trainer.iterations} steps in {wall:.3f} s, result "
          f"{json.dumps(result)}; attribution of steps 1-3: " + "; ".join(
              f"wall {a['wall_s'] * 1e3:.1f} ms = data_wait {a['data_wait_s'] * 1e3:.1f} + "
              f"dispatch {a['dispatch_s'] * 1e3:.1f} + device_step {a['device_step_s'] * 1e3:.1f} "
              f"(readback {a['metric_readback_s'] * 1e3:.1f}) + checkpoint "
              f"{a['checkpoint_s'] * 1e3:.1f} + validate {a['validate_s'] * 1e3:.1f} + residual "
              f"{a['residual_s'] * 1e3:.1f}, stage {a['stage_megabatch_s'] * 1e3:.1f} overlapped"
              for a in attribution[1:]) + f"; device_step median {dev_ms[len(dev_ms) // 2]:.1f} ms")
    peak = max(r["value"] for r in by_type["gauge"] if r["name"] == "device_mem_peak_bytes")
    print(f"train runtime watermark: peak {peak / 2**30:.3f} GiB of the card")
    sink_write_cost(tel, run.log_dir, trainer.iterations, "step", card)

    cap = events["profiler_capture"]
    if not cap["ok"] or cap["steps_covered"] != 2:
        fail(f"the profiler capture: {cap}")
    with open(cap["file"]) as f:
        prof = json.load(f)
    kernels = sorted({e["name"] for e in prof["traceEvents"]
                      if e.get("cat") == "kernel" and "dcn_" in e.get("name", "")})
    print(f"profiler capture {os.path.basename(cap['file'])}: {len(prof['traceEvents'])} "
          f"events; dcn kernels {kernels}")
    if not kernels:
        fail("the profiler trace holds no dcn_* kernel")
    del prof
    cli = [sys.executable, "-m", "esr_tpu_torch.obs"]
    rep = subprocess.run(cli + ["report", tel, "--slo", str(repo / "configs" / "slo.yml")],
                         capture_output=True, text=True, timeout=300, cwd=str(repo))
    if rep.returncode != 0:
        fail(f"obs report on the runtime run exited {rep.returncode}: {rep.stderr[-2000:]}")
    goodput = json.loads(rep.stdout)["report"]["goodput"]
    exp = subprocess.run(cli + ["export", tel, "-o",
                                os.path.join(trainer.trace_dir, "telemetry.trace.json")],
                         capture_output=True, text=True, timeout=300, cwd=str(repo))
    if exp.returncode != 0:
        fail(f"obs export exited {exp.returncode}: {exp.stderr[-2000:]}")
    print(f"obs report: slo.yml green, goodput {goodput}; obs export: {exp.stdout.strip()}")

    dataset = trainer.train_loader.dataset
    batch = collate_sequences([dataset.get_item(i, seed=i) for i in range(32)])
    sel = trainer._select(batch)
    ways = step_ways(torch, trainer, sel, card)
    transfer_bf16_step(torch, trainer, batch, repo, overrides, card, recs)
    print(f"train runtime phase (run, steps, bf16) {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    summary = chaos.run_scenario(os.path.join(out_root, "chaos"), seed=0, basech=8,
                                 device="cuda")
    chaos_wall = time.perf_counter() - t0
    slo = str(repo / "configs" / "slo_chaos.yml")
    codes = {phase: report_file(path, slo_path=slo)[1] for phase, path in (
        ("train", summary["chaos"]["telemetry"]), ("serve", summary["serve_telemetry"]))}
    print(f"chaos scenario at basech 8 on {card}: {chaos_wall:.1f} s (twin "
          f"{summary['twin']['wall_s']} s, chaos {summary['chaos']['wall_s']} s, restore and "
          f"serve {summary['serve_wall_s']} s); checks {json.dumps(summary['checks'])}; faults "
          f"{summary['faults']['injected']} injected, {summary['faults']['unrecovered']} "
          f"unrecovered; rollbacks {summary['chaos']['rollbacks']}, skipped "
          f"{summary['chaos']['skipped_iterations']}, bad tag {summary['chaos']['last_bad_tag']}; "
          f"params against the twin max rel {summary['params_max_rel_diff']!r}, "
          f"{'bitwise' if summary['params_bitwise'] else 'not bitwise'}; slo_chaos.yml {codes}")
    if (not summary["ok"] or summary["faults"]["unrecovered"] != 0
            or any(codes.values()) or not summary["params_max_rel_diff"] <= 1e-5):
        fail("the chaos scenario on the card is not green")
    return {"ways": ways, "chaos_s": chaos_wall, "run_s": wall}


def check_writer_records(run, trainer):
    """The writer's JSONL records of the trainer's run (the config as
    written: tensorboard and vis on): every iteration's losses, the learning
    rate at every log step, ``steps_per_sec``, the validation stamp, and the
    five images of the vis steps (every ``train_img_writer_num``-th
    iteration)."""
    import importlib.util

    with open(Path(run.log_dir) / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    tags = {(r["step"], r["tag"]) for r in records}
    images = [r for r in records if r.get("image")]
    vis_steps = [i for i in range(trainer.iterations) if i % trainer.train_vis_step == 0]
    missing = [(i, k) for i in range(trainer.iterations)
               for k in ("train_loss/train", "train_mse_loss/train", "learning_rate/train")
               if (i, k) not in tags]
    if (missing or len(images) != 5 * len(vis_steps) or not any(
            t == "steps_per_sec/train" for _, t in tags)
            or not any(t.startswith("stamp_valid_loss") for _, t in tags)
            or not all(math.isfinite(r["value"]) for r in records if "value" in r)):
        fail(f"the writer's records are incomplete: missing {missing}, {len(images)} images "
             f"for vis steps {vis_steps}")
    print(f"writer: {len(records)} JSONL records, {len(images)} images rendered at steps "
          f"{sorted({r['step'] for r in images})} ({sorted({r['tag'] for r in images})}); "
          f"tensorboard importable: {importlib.util.find_spec('tensorboard') is not None}")


def batch_build(np, train_recs, dataset_config, batch_size, card):
    """The B=32 batch build of the trainer's loader (its item keys, its
    augmentation), with the native host kernels and with numpy
    (``ESR_TPU_NATIVE=0``), each at ``num_workers`` 0, 2 and 4: ms per batch
    over one epoch after warm ones (the worker pool up), the warm epochs'
    wall beside it. A route's two worker pools boot side by side first (a
    spawn pickles the recordings to its worker and takes seconds; a pool
    spawns its workers one by one, and only while none is idle, so each
    worker's first task waits for all of them), then each configuration is
    timed alone.
    The native route must take every encoder call of the in-process build
    and numpy none, and the reverse; every configuration's first batch is
    bitwise the in-process native one."""
    import multiprocessing
    import threading

    from esr_tpu_torch.data import np_encodings as NE
    from esr_tpu_torch.data.loader import ConcatSequenceDataset, SequenceLoader

    def boot(loader, barrier, errors):
        try:
            pool = loader._get_pool()
            for f in [pool.submit(barrier.wait, 300) for _ in range(loader.num_workers)]:
                f.result(timeout=600)
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errors.append(f"num_workers {loader.num_workers}: {e!r}")

    dataset = ConcatSequenceDataset(train_recs, dataset_config)
    first, per_batch = {}, {}
    for route in ("native", "numpy"):
        if route == "numpy":
            os.environ["ESR_TPU_NATIVE"] = "0"
        loaders = {w: SequenceLoader(dataset, batch_size, seed=0, prefetch=2, num_workers=w)
                   for w in (0, 2, 4)}
        try:
            t0 = time.perf_counter()
            errors = []
            with multiprocessing.get_context("spawn").Manager() as manager:
                boots = [threading.Thread(target=boot, args=(loaders[w], manager.Barrier(w),
                                                             errors)) for w in (2, 4)]
                for t in boots:
                    t.start()
                for t in boots:
                    t.join()
            if errors:
                fail(f"the {route} batch build's worker pools did not boot: {errors}")
            booted = time.perf_counter() - t0
            for workers, loader in loaders.items():
                NE.ROUTES.reset()
                t0 = time.perf_counter()
                first[route, workers] = next(iter(list(loader)))
                warm = 2 if workers else 1
                for epoch in range(1, warm):
                    loader.set_epoch(epoch)
                    sum(1 for _ in loader)
                t1 = time.perf_counter()
                n = 0
                for epoch in range(warm, warm + 1):
                    loader.set_epoch(epoch)
                    n += sum(1 for _ in loader)
                t2 = time.perf_counter()
                loader.close()
                routes = NE.ROUTES.snapshot()
                if workers == 0 and (routes[route] == 0 or routes["numpy" if route == "native"
                                                                 else "native"] != 0):
                    fail(f"the {route} batch build took the routes {routes}")
                per_batch[route, workers] = (t2 - t1) / n * 1e3
                print(f"batch build on the host of {card}: B={batch_size} {route} "
                      f"num_workers {workers}: {per_batch[route, workers]:.3f} ms per batch "
                      f"over {n} batches of one epoch after {warm} warm ones (those "
                      f"{(t1 - t0) * 1e3:.3f} ms"
                      + (f"; the route's pools booted side by side in {booted:.3f} s"
                         if workers else "") + f"); in-process routes {routes}")
        finally:
            for loader in loaders.values():
                loader.close()
            os.environ.pop("ESR_TPU_NATIVE", None)
    ref = first["native", 0]
    for key, batch in first.items():
        if sorted(batch) != sorted(ref) or not all(np.array_equal(batch[k], ref[k]) for k in ref):
            fail(f"the batch of {key} differs from the in-process native batch")
    print("batch build: every route and worker count gives the same first batch bitwise; "
          "numpy / native at num_workers 0: "
          f"{per_batch['numpy', 0] / per_batch['native', 0]:.3f}x; native 0 / 4 workers: "
          f"{per_batch['native', 0] / per_batch['native', 4]:.3f}x")


def device_rasterize_step(torch, dev, trainer, repo: Path, overrides, train_recs, valid_recs):
    """One B=32 step of the flagship config with ``trainer;device_rasterize=
    true`` from the basech-8 trainer's weights: the loader ships raw event
    windows, the device rasterizes them, bitwise the host's count images of
    the same sequences; 14/14/14 train launches; its loss within 1e-6
    relative of the host-rasterized step's from the same weights."""
    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.data.loader import ConcatSequenceDataset, collate_sequences
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.training.trainer import Trainer

    run = RunConfig.from_args(str(repo / "configs" / "train_esr_2x.yml"),
                              overrides=overrides + ["trainer;device_rasterize=true"],
                              runid="chip_smoke_device_rasterize", seed=0)
    dtrainer = Trainer(run, device=dev, train_recordings=train_recs,
                       valid_recordings=valid_recs)
    if not dtrainer.device_rasterize:
        fail("trainer;device_rasterize=true did not reach the trainer")
    dtrainer.model.load_state_dict(trainer.model.state_dict())
    loader = dtrainer.train_loader
    t0 = time.perf_counter()
    raw = next(iter(loader))
    build_ms = (time.perf_counter() - t0) * 1e3
    if "inp_norm_events" not in raw or "inp_scaled_cnt" in raw:
        fail(f"the device-rasterize loader built {sorted(raw)}")
    # the host's count images of the same sequences and seeds
    indices = list(loader.sampler)[0]
    host = collate_sequences([ConcatSequenceDataset(
        train_recs, {**loader.dataset.config, "item_keys": ["inp_scaled_cnt", "gt_cnt"]}
    ).get_item(int(i), seed=s) for i, s in zip(indices, loader._seeds(indices))])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dsel = dtrainer._select(raw)
    torch.cuda.synchronize()
    raster_ms = (time.perf_counter() - t0) * 1e3
    hsel = {"inp": torch.from_numpy(host["inp_scaled_cnt"]).to(dev),
            "gt": torch.from_numpy(host["gt_cnt"]).to(dev)}
    for k in ("inp", "gt"):
        if not same_bits(torch, dsel[k], hsel[k]):
            fail(f"the device-rasterized {k} is not bitwise the host's")
    state = copy.deepcopy(dtrainer.model.state_dict())
    dcn_cuda.reset_launches()
    loss_d = float(dtrainer.train_step(dsel)["loss"])
    torch.cuda.synchronize()
    n = 2 * TRAIN_WINDOWS
    if counts_of() != dict(only("dcn_train_fwd", n), dcn_bwd=n, dcn_wgrad=n):
        fail(f"the device-rasterized step launched {counts_of()}")
    dtrainer.model.load_state_dict(state)
    loss_h = float(dtrainer.train_step(hsel)["loss"])
    rel = abs(loss_d - loss_h) / max(abs(loss_h), TINY)
    print(f"device-rasterized step: raw batch build {build_ms:.3f} ms, rasterized on the card "
          f"in {raster_ms:.3f} ms, inputs bitwise the host's; loss {loss_d!r} vs host "
          f"{loss_h!r}, relative {rel:.3e} (limit 1e-6)")
    if not rel <= 1e-6:
        fail("the device-rasterized step's loss differs from the host-rasterized step's")


def basech_step(torch, np, dev, trainer, sel, repo: Path, overrides, card, step8_ms,
                basech: int, f64: bool = False):
    """One step of the flagship config at ``basech`` (the override
    ``model;args;basech=...``: a 8*basech-channel DCN bottleneck of basech
    channels per group) from seeded params, the offset/mask conv made
    nonzero, on ``sel`` (the basech-8 step's batch or its first images): 14
    launches each of ``dcn_train_fwd``, ``dcn_bwd`` and ``dcn_wgrad``, and
    the losses and every parameter's grad within 1e-3 of their own scale of
    the plain path's; with ``f64`` both paths' grads against the plain path
    run in f64. Then its step time, optimizer included, beside the basech-8
    step's (when given)."""
    from esr_tpu_torch.config.build import build_model, build_optimizer
    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.training.train_step import make_train_step, window_losses

    run = RunConfig.from_args(str(repo / "configs" / "train_esr_2x.yml"),
                              overrides=overrides + [f"model;args;basech={basech}"],
                              runid=f"chip_smoke_basech{basech}", seed=0)
    torch.manual_seed(0)
    model = build_model(run.config["model"])
    if model.basech != basech:
        fail(f"the override model;args;basech={basech} did not reach the model")
    rng = np.random.default_rng(basech)
    om = model.spacetime_fuse.dcn_offset_mask
    with torch.no_grad():
        om.weight.copy_(torch.from_numpy(
            (rng.standard_normal(tuple(om.weight.shape)) * 0.05).astype(np.float32)))
        om.bias.copy_(torch.from_numpy(rng.standard_normal(tuple(om.bias.shape)).astype(np.float32)))
    model = model.to(dev)
    n = 2 * TRAIN_WINDOWS
    losses, grads = {}, {}
    for path in ("kernel", "plain"):
        m = copy.deepcopy(model).train()
        m.spacetime_fuse.dcn_impl = "auto" if path == "kernel" else "plain"
        dcn_cuda.reset_launches()
        per_window, _ = window_losses(m, sel, trainer.seqn)
        per_window.sum().backward()
        torch.cuda.synchronize()
        want = (dict(only("dcn_train_fwd", n), dcn_bwd=n, dcn_wgrad=n) if path == "kernel"
                else only("dcn_train_fwd", 0))
        if counts_of() != want:
            fail(f"the basech-{basech} step on the {path} path launched {counts_of()}, "
                 f"should be {want}")
        losses[path] = per_window.detach()
        grads[path] = {name: p.grad for name, p in m.named_parameters()}
    print(f"basech-{basech} step (batch {sel['inp'].shape[0]}) launches {dict(only('dcn_train_fwd', n), dcn_bwd=n, dcn_wgrad=n)}")
    err, scale, limit = rel_err_of(torch, losses["kernel"], losses["plain"])
    print(f"basech-{basech} step kernel vs plain: loss_per_window max_abs_err {err:.3e} "
          f"(scale {scale:.3e}, limit {limit:.3e})")
    if not err <= limit:
        fail(f"the basech-{basech} step's losses differ between the kernel and plain paths")
    rows = sorted(((e / max(s, TINY), name, e, s, lim) for name, ref in grads["plain"].items()
                   for e, s, lim in [rel_err_of(torch, grads["kernel"][name], ref)]),
                  reverse=True)
    print(f"basech-{basech} step kernel vs plain grads: {len(rows)} parameters; worst err/scale "
          + "; ".join(f"{name} {e:.3e}/{s:.3e} = {r:.3e}" for r, name, e, s, _ in rows[:5]))
    bad = [name for _, name, e, _, lim in rows if not e <= lim]
    if bad:
        fail(f"the basech-{basech} step's grads differ from the plain path's beyond {TOL} of "
             f"their own scale: {bad}")
    if f64:
        # the plain path in f64 as the floor of f32 agreement: each f32
        # path's distance from it, per DCN parameter and at worst
        m = copy.deepcopy(model).double().train()
        m.spacetime_fuse.dcn_impl = "plain"
        per_window, _ = window_losses(m, {k: v.double() for k, v in sel.items()}, trainer.seqn)
        per_window.sum().backward()
        ref64 = {name: p.grad for name, p in m.named_parameters()}
        del m
        for path in ("kernel", "plain"):
            errs = {name: float((grads[path][name].double() - ref).abs().max())
                    / max(float(ref.abs().max()), TINY) for name, ref in ref64.items()}
            worst = max(errs, key=errs.get)
            print(f"basech-{basech} step, {path} path vs the plain path in f64: "
                  + "; ".join(f"{n} {errs[n]:.3e}" for n in errs if n.startswith(
                      "spacetime_fuse.dcn_")) + f"; worst {worst} {errs[worst]:.3e}")

    opt, _ = build_optimizer(run.config["optimizer"], model.parameters(),
                             run.config.get("lr_scheduler"),
                             run.config["trainer"]["iteration_based_train"].get("lr_change_rate"))
    step = make_train_step(model, opt, trainer.seqn)
    for _ in range(2):  # warm
        step(sel)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(sel)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"train step on {card}: batch {sel['inp'].shape[0]}, basech {basech} "
          f"{sorted(times)[1]:.3f} ms median of 3 ({', '.join(f'{t:.3f}' for t in times)})"
          + (f"; basech 8 {step8_ms:.3f} ms" if step8_ms is not None else "")
          + " (host clock to synchronize, optimizer included)")


def c2_bitwise_step(torch, trainer, sel, what: str = "B=32 flagship"):
    """C2: two train steps of ``trainer``'s model (the trainer's step: BPTT,
    the backward, Adam-amsgrad) from the same params, optimizer state and
    batch give the same bits: the per-window losses, every gradient and
    every updated parameter. Fails otherwise."""
    from esr_tpu_torch.training.train_step import make_train_step

    runs = []
    for _ in range(2):
        model, opt = copy.deepcopy((trainer.model, trainer.optimizer))
        metrics = make_train_step(model, opt, trainer.seqn)(sel)
        torch.cuda.synchronize()
        runs.append((metrics["loss_per_window"],
                     {n: p.grad.clone() for n, p in model.named_parameters()},
                     {n: p.detach().clone() for n, p in model.named_parameters()}))
    (l0, g0, p0), (l1, g1, p1) = runs
    bad_g = [n for n in g0 if not same_bits(torch, g0[n], g1[n])]
    bad_p = [n for n in p0 if not same_bits(torch, p0[n], p1[n])]
    print(f"C2: two {what} train steps from the same state: losses "
          f"{'bitwise' if same_bits(torch, l0, l1) else 'DIFFER'}; "
          f"{len(g0) - len(bad_g)} of {len(g0)} grads and {len(p0) - len(bad_p)} of "
          f"{len(p0)} updated params bitwise")
    if not same_bits(torch, l0, l1) or bad_g or bad_p:
        fail(f"the train step is not bitwise run to run: grads {bad_g}, params {bad_p}")


def sparse_train_step(torch, dev, trainer, sel, repo: Path, overrides):
    """One B=32 step of the flagship config with ``model;args;dcn_sparse=true``
    against the dense kernel step, from the same params and batch: 14
    launches each of ``dcn_train_fwd_masked``, ``dcn_bwd`` and ``dcn_wgrad``;
    the mask is all active (the DCN input is never all zero), and the masked
    forward is bitwise the dense one on a truthful mask, the backward the
    same dense kernels, and the step bitwise run to run (C2): so the losses
    and every grad are bitwise the dense step's, and the dense step's
    bitwise its own repeat."""
    from esr_tpu_torch.config.build import build_model
    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.training.train_step import window_losses

    run = RunConfig.from_args(str(repo / "configs" / "train_esr_2x.yml"),
                              overrides=overrides + ["model;args;dcn_sparse=true"],
                              runid="chip_smoke_sparse", seed=0)
    sparse = build_model(run.config["model"])
    if not sparse.spacetime_fuse.dcn_sparse:
        fail("the override model;args;dcn_sparse=true did not reach the model")
    sparse.load_state_dict(trainer.model.state_dict())
    runs = {}
    for name in ("dense", "dense_again", "sparse"):
        model = (sparse if name == "sparse" else copy.deepcopy(trainer.model)).to(dev).train()
        for p in model.parameters():
            p.grad = None
        dcn_cuda.reset_launches()
        per_window, _ = window_losses(model, sel, trainer.seqn)
        per_window.sum().backward()
        torch.cuda.synchronize()
        runs[name] = (counts_of(), per_window.detach(),
                      {n: p.grad for n, p in model.named_parameters()})
    n = 2 * TRAIN_WINDOWS
    want = {"sparse": dict(only("dcn_train_fwd_masked", n), dcn_bwd=n, dcn_wgrad=n),
            "dense": dict(only("dcn_train_fwd", n), dcn_bwd=n, dcn_wgrad=n)}
    print(f"sparse step launches {runs['sparse'][0]}; dense step {runs['dense'][0]}")
    if runs["sparse"][0] != want["sparse"] or runs["dense"][0] != want["dense"]:
        fail(f"the sparse / dense steps launched {runs['sparse'][0]} / {runs['dense'][0]}")
    if not same_bits(torch, runs["sparse"][1], runs["dense"][1]):
        fail("the sparse step's per-window losses are not bitwise the dense step's")
    dense = runs["dense"][2]
    not_sparse = [n for n, g in dense.items() if not same_bits(torch, runs["sparse"][2][n], g)]
    not_again = [n for n, g in dense.items()
                 if not same_bits(torch, runs["dense_again"][2][n], g)]
    print(f"sparse vs dense step: per-window losses bitwise; "
          f"{len(dense) - len(not_sparse)} of {len(dense)} grads bitwise (the dense step "
          f"against itself: {len(dense) - len(not_again)})")
    if not_sparse or not_again:
        fail(f"grads not bitwise: sparse vs dense {not_sparse}, dense vs dense {not_again}")
    return runs["sparse"][0]["dcn_train_fwd_masked"]


def same_bits(torch, a, b) -> bool:
    """Bitwise equality (NaNs included) of two f32 tensors."""
    return tuple(a.shape) == tuple(b.shape) and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def nan_aware_err(torch, got, ref):
    """(max abs err over finite reference values, limit, NaN positions agree)."""
    fin = torch.isfinite(ref)
    err = float((got[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
    limit = TOL * max(float(ref[fin].abs().max()) if bool(fin.any()) else 0.0, 1.0)
    return err, limit, torch.equal(torch.isnan(got), torch.isnan(ref))


def masked_bound(inp, out, share: float, n_tiles: int):
    """The roofline of a masked call at this active share: the inactive
    images' x, offsets and mask are not read and their contraction and
    gather are not done; W, the bias, the bitmap and the output are."""
    b = inp["x"].shape[0]
    per_image = nbytes(inp["x"], inp["offsets"], inp["mask"])
    rest = nbytes(inp["weight"], inp["bias"], out) + 4.0 * b * n_tiles
    return roofline(share * per_image + rest,
                    share * (contraction_flops(inp) + gather_flops(inp)))


def entry_launch(torch, wrapper, inp, tm, direction):
    """A launch of a masked kernel straight through its C entry point (not
    counted), its int32 bitmap and output made once."""
    from esr_tpu_torch.ops import dcn as plain
    from esr_tpu_torch.ops import dcn_cuda

    x, off, wt = inp["x"], inp["offsets"], inp["weight"]
    b, ho, wo = off.shape[:3]
    no_tile, n_tiles = plain.output_tiling(x, off, direction)
    am = plain.tile_mask_grid(tm, b, n_tiles)
    out = torch.empty((b, ho, wo, wt.shape[-1]), device=x.device)
    cfg = dcn_cuda.fwd_config(b * ho * wo, wt.shape[-1])
    return fwd_entry(torch, wrapper.library.load(), wrapper.entry, inp, out, cfg, am=am,
                     tiling=(n_tiles, no_tile))


def phase_masked_kernels(torch, np, card):
    """The masked kernels against their dense kernels (bitwise, on truthful
    masks: an inactive image is all zero) and against the plain
    ``deform_conv2d_masked`` (1e-3 * max(|ref|, 1)), at the flagship shape:
    ``dcn_fwd_masked`` at B=1, 4 (the lanes), 8 and 32, ``dcn_train_fwd_masked``
    at B=32 (tiles of 32 rows there straddle images: 240 % 32 != 0). Masks:
    all active, all inactive, half of the images zeroed and inactive, an
    explicit ``[B, n_tiles]`` mask, a NaN image kept active by
    ``dcn_image_activity``; and an explicit multi-tile mask on a 64x64 image
    whose masked-off tiles are not zero (bitwise to dense on active rows,
    exactly the bias elsewhere). Times at 0, 50 and 100% active beside the
    dense kernel and the bound."""
    from esr_tpu_torch.ops import dcn as plain
    from esr_tpu_torch.ops.dcn_cuda import (dcn_fwd, dcn_fwd_masked, dcn_train_fwd,
                                            dcn_train_fwd_masked)

    rng = np.random.default_rng(3)
    pairs = {"fwd": (dcn_fwd_masked, dcn_fwd), "train": (dcn_train_fwd_masked, dcn_train_fwd)}
    record = {"dcn_fwd_masked": {}, "dcn_train_fwd_masked": {}}
    worst = {"dcn_fwd_masked": 0.0, "dcn_train_fwd_masked": 0.0}
    runs = [("fwd", b) for b in (1, 4, 8, 32)] + [("train", 32)]
    for direction, b in runs:
        masked, dense = pairs[direction]
        base = dcn_inputs(torch, rng, b=b, h=12, w=20, cin=64, cout=64, dg=8)
        _, n_tiles = plain.output_tiling(base["x"], base["offsets"], direction)
        half_x = base["x"].clone()
        half_x[1::2] = 0.0
        half_tm = (torch.arange(b, device=half_x.device) % 2 == 0).float()
        nan_x = base["x"].clone()
        nan_x[0, 3, 4, 5] = float("nan")
        cases = {
            "all_active": (base["x"], torch.ones(b, device=half_x.device)),
            "all_inactive": (torch.zeros_like(base["x"]), torch.zeros(b, device=half_x.device)),
            "half": (half_x, half_tm),
            "explicit_tiles": (half_x, half_tm[:, None].expand(b, n_tiles).contiguous()),
            "nan_image": (nan_x, plain.dcn_image_activity(nan_x)),
        }
        for case, (x, tm) in cases.items():
            inp = dict(base, x=x)
            got = masked(**inp, tile_mask=tm)
            ref_dense = dense(**inp)
            ref_plain = plain.deform_conv2d_masked(**inp, tile_mask=tm, direction=direction)
            torch.cuda.synchronize()
            err, limit, nan_ok = nan_aware_err(torch, got, ref_plain)
            bitwise = same_bits(torch, got, ref_dense)
            print(f"masked {masked.name} B={b} {case}: bitwise to {dense.name} {bitwise}; "
                  f"max_abs_err vs plain {err:.3e} (limit {limit:.3e})")
            if not (bitwise and nan_ok and err <= limit):
                fail(f"{masked.name} at B={b} on {case}: bitwise {bitwise}, NaNs agree "
                     f"{nan_ok}, err {err:.3e} > {limit:.3e}?")
            if case == "nan_image" and not bool(torch.isnan(got[0]).any()):
                fail(f"{masked.name}: the NaN image's output is not NaN")
            worst[masked.name] = max(worst[masked.name], err * TOL / limit)
            if case == "all_active":
                record[masked.name][f"b{b}"] = {"err": err}
        # times at 0, 50 and 100% active, beside the dense kernel: through
        # the wrappers (what the model pays: the bitmap's conversion too)
        # and through the C entry point alone, the bitmap ready
        timing = {0.0: cases["all_inactive"], 0.5: cases["half"], 1.0: cases["all_active"]}
        for share, (x, tm) in timing.items():
            inp = dict(base, x=x)
            out = masked(**inp, tile_mask=tm)
            ms = time_ms(torch, lambda: masked(**inp, tile_mask=tm), iters=300)
            dense_ms = time_ms(torch, lambda: dense(**inp), iters=300)
            entry_ms = time_ms(torch, entry_launch(torch, masked, inp, tm, direction),
                               iters=300)
            bound_ms, bound_by = masked_bound(inp, out, share, n_tiles)
            entry = {"ms": ms, "entry_ms": entry_ms, "dense_ms": dense_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
            plain_note = ""
            if share == 1.0:
                entry["plain_ms"] = time_ms(
                    torch, lambda: plain.deform_conv2d_masked(
                        **inp, tile_mask=tm, direction=direction), iters=50)
                plain_note = f", plain {entry['plain_ms']:.5f} ms"
            record[masked.name].setdefault(f"b{b}", {})[f"active{int(share * 100)}"] = entry
            print(f"time {masked.name} B={b} {int(share * 100)}% active: masked {ms:.5f} ms "
                  f"(entry point alone {entry_ms:.5f}), dense {dense_ms:.5f} ms{plain_note}, "
                  f"bound {bound_ms:.6f} ms ({bound_by}) on {card}")

    # an explicit multi-tile mask (64x64: 32 forward tiles of 128 pixels,
    # 16 train tiles of 256): active rows bitwise to dense, the rest the bias
    for direction in ("fwd", "train"):
        masked, dense = pairs[direction]
        inp = dcn_inputs(torch, rng, b=2, h=64, w=64, cin=16, cout=16, dg=2)
        no_tile, n_tiles = plain.output_tiling(inp["x"], inp["offsets"], direction)
        tm = torch.from_numpy((rng.random((2, n_tiles)) < 0.5).astype(np.float32)).cuda()
        got = masked(**inp, tile_mask=tm)
        ref_dense = dense(**inp)
        ref_plain = plain.deform_conv2d_masked(**inp, tile_mask=tm, direction=direction)
        torch.cuda.synchronize()
        active = (tm[:, torch.arange(64 * 64, device=tm.device) // no_tile] > 0).reshape(2, 64, 64)
        err, limit, _ = nan_aware_err(torch, got, ref_plain)
        ok_active = same_bits(torch, got[active], ref_dense[active])
        ok_bias = torch.equal(got[~active], (0.0 + inp["bias"]).expand_as(got[~active]))
        print(f"masked {masked.name} 64x64 explicit [2, {n_tiles}] mask: active rows bitwise "
              f"{ok_active}, masked-off rows the bias {ok_bias}, err vs plain {err:.3e}")
        if not (ok_active and ok_bias and err <= limit):
            fail(f"{masked.name} on an explicit multi-tile mask")
        worst[masked.name] = max(worst[masked.name], err * TOL / limit)
    try:
        dcn_fwd_masked(**base, tile_mask=torch.ones(base["x"].shape[0], 2, device="cuda"))
    except ValueError as e:
        print(f"masked: a mask of the wrong shape raises: {e}")
    else:
        fail("dcn_fwd_masked took a mask of the wrong shape")
    return record, worst


def flagship_model(torch, np, dcn_sparse: bool):
    """The flagship DeepRecurrNet (basech 8, seqn 3) with seeded random
    weights brought in through the flax weight bridge, the offset/mask conv
    made nonzero so the DCN really deforms."""
    from esr_tpu_torch.models import convert
    from esr_tpu_torch.models.esr import DeepRecurrNet

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    tree = convert.export_flax_params(DeepRecurrNet(inch=2, basech=8, num_frame=3))
    om = tree["params"]["spacetime_fuse"]["dcn_offset_mask"]
    om["kernel"] = (rng.standard_normal(om["kernel"].shape) * 0.05).astype(np.float32)
    om["bias"] = rng.standard_normal(om["bias"].shape).astype(np.float32)
    model = DeepRecurrNet(inch=2, basech=8, num_frame=3, dcn_sparse=dcn_sparse)
    convert.load_flax_params(model, tree)
    return model


def counts_of():
    from esr_tpu_torch.ops import dcn_cuda

    return {k.name: k.launches for k in dcn_cuda.KERNELS}


def only(name: str, n: int):
    """The launch counts of a run that launched ``n`` of ``name`` and
    nothing else."""
    return {k: (n if k == name else 0) for k in counts_of()}


def phase_engine(torch, np, dev, card):
    """The streaming engine on the sparse flagship at lanes 4 / chunk 8 over
    6 seeded 720x1280 recordings of unequal length (lanes refill mid-run)."""
    from torch.profiler import ProfilerActivity, profile

    from esr_tpu_torch.data import np_encodings as NE
    from esr_tpu_torch.data.loader import LanePackedChunks
    from esr_tpu_torch.data.synthetic import make_synthetic_recording
    from esr_tpu_torch.inference.engine import METRIC_KEYS, StreamingEngine
    from esr_tpu_torch.inference.harness import InferenceRunner
    from esr_tpu_torch.ops import dcn_cuda

    t0 = time.perf_counter()
    recs = [make_synthetic_recording((720, 1280), base_events=ev, num_frames=2,
                                     rungs=("down8", "down16"), seed=30 + i,
                                     name=f"engine{i}")
            for i, ev in enumerate((120_000, 200_000, 80_000, 160_000, 100_000, 140_000))]
    model = flagship_model(torch, np, dcn_sparse=True)
    engine = StreamingEngine(model, 3, lanes=LANES, chunk_windows=CHUNK_WINDOWS, device=dev)
    engine.run_datalist(recs[:1], FLAGSHIP_DATA)  # warm: cuDNN picks its algorithms
    torch.cuda.synchronize()
    print(f"engine setup: {time.perf_counter() - t0:.2f} s")

    dcn_cuda.reset_launches()
    NE.ROUTES.reset()
    t0 = time.perf_counter()
    results, names = engine.run_datalist(recs, FLAGSHIP_DATA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_of()
    routes = NE.ROUTES.snapshot()
    if routes["native"] == 0 or routes["numpy"] != 0:
        fail(f"the engine's host data path took the routes {routes}, not the native one")
    n_chunks = len(engine.chunk_seconds)
    n_windows = int(sum(r["n_windows"] for r in results))
    print(f"engine: {n_windows} windows of {len(recs)} recordings "
          f"({[int(r['n_windows']) for r in results]}) in {n_chunks} chunks of "
          f"{LANES} lanes x {CHUNK_WINDOWS} windows, {wall:.3f} s; launches {counts}")
    if counts != only("dcn_fwd_masked", 2 * CHUNK_WINDOWS * n_chunks):
        fail(f"the engine launched {counts}, expected only dcn_fwd_masked, 2 per window "
             f"step ({2 * CHUNK_WINDOWS * n_chunks})")
    if n_chunks <= -(-len(recs) // LANES):
        fail(f"{n_chunks} chunks: the lanes did not refill mid-run")
    chunk_ms = sorted(s * 1e3 for s in engine.chunk_seconds)
    print(f"engine on {card}: {n_windows / wall:.3f} windows/s (native rasterization, "
          f"routes {routes}); chunk (dispatch to readback) p50 "
          f"{chunk_ms[len(chunk_ms) // 2]:.3f} ms, max {chunk_ms[-1]:.3f} ms")
    # the same run on the numpy route, then native again
    walls = {"native": [wall]}
    for route in ("numpy", "native"):
        if route == "numpy":
            os.environ["ESR_TPU_NATIVE"] = "0"
        try:
            NE.ROUTES.reset()
            t0 = time.perf_counter()
            again, _ = engine.run_datalist(recs, FLAGSHIP_DATA)
            torch.cuda.synchronize()
            walls.setdefault(route, []).append(time.perf_counter() - t0)
        finally:
            os.environ.pop("ESR_TPU_NATIVE", None)
        if NE.ROUTES.snapshot()[route] == 0:
            fail(f"the {route} engine run took the routes {NE.ROUTES.snapshot()}")
        # the same inputs bit for bit; cuDNN may pick other algorithms
        if any(abs(a[k] - b[k]) > 1e-6 * max(abs(b[k]), 1e-12)
               for a, b in zip(again, results) for k in METRIC_KEYS):
            fail(f"the engine's metrics on the {route} route differ from the first run's")

    runner = InferenceRunner(model, 3, device=dev)
    worst = 0.0
    for rec, res in zip(recs, results):
        seq = runner.run_recording(rec, FLAGSHIP_DATA, report=False)
        if res["n_windows"] != seq["n_windows"] or set(res) != set(seq):
            fail(f"engine result of {rec.name} differs in schema or windows from the harness")
        for k in METRIC_KEYS + ("esr_rmse", "bicubic_rmse"):
            if not math.isfinite(res[k]):
                fail(f"engine {rec.name}: {k} is not finite")
            worst = max(worst, abs(res[k] - seq[k]) / max(abs(seq[k]), 1e-12))
    print(f"engine vs sequential harness: worst relative metric difference {worst:.3e} "
          f"(limit {ENGINE_TOL})")
    if not worst <= ENGINE_TOL:
        fail("the engine's metrics differ from the sequential harness's")

    model.spacetime_fuse.dcn_impl = "plain"
    dcn_cuda.reset_launches()
    plain_results, _ = StreamingEngine(model, 3, lanes=LANES, chunk_windows=CHUNK_WINDOWS,
                                       device=dev).run_datalist(recs, FLAGSHIP_DATA)
    model.spacetime_fuse.dcn_impl = "auto"
    if any(counts_of().values()):
        fail(f"the plain engine launched {counts_of()}")
    worst_plain = max(abs(a[k] - b[k]) / max(abs(b[k]), 1.0)
                      for a, b in zip(results, plain_results) for k in METRIC_KEYS)
    print(f"engine kernel path vs plain path: worst scale-normalized metric difference "
          f"{worst_plain:.3e} (limit {TOL})")
    if not worst_plain <= TOL:
        fail("the engine's kernel path differs from its plain path")

    # where one chunk's time goes
    chunk = next(iter(LanePackedChunks(recs[1:2] * LANES, FLAGSHIP_DATA, lanes=LANES,
                                       chunk_windows=CHUNK_WINDOWS)))
    staged = engine._wait(engine._stage(chunk))
    windows = {k: staged[k] for k in ("inp_scaled", "gt", "inp_mid", "valid")}
    states = model.init_states(LANES, *chunk["windows"]["gt"].shape[2:4], device=dev)
    engine._run_chunk(states, staged["reset_keep"], windows)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine._run_chunk(states, staged["reset_keep"], windows)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = device_time_breakdown(torch, prof, 1, prof_ms, "chunk", card)
    for route, ws in walls.items():
        idle = ("not measured" if busy_ms is None else
                ", ".join(f"{1 - n_chunks * busy_ms / (w * 1e3):.3f}" for w in ws))
        print(f"engine on {card}, {route} rasterization: "
              + ", ".join(f"{n_windows / w:.3f}" for w in ws)
              + f" windows/s; device idle share of the run (1 - {n_chunks} chunks x "
              f"device-busy per chunk / wall): {idle}")
    return counts["dcn_fwd_masked"], {"windows_per_s": n_windows / wall,
                                      "chunk_p50_ms": chunk_ms[len(chunk_ms) // 2]}


# serving streams: time-mode windows (the reference's gating profile: a
# bursty stream's tail windows are nearly idle), 1 s recordings at 720x1280;
# sequences of L 3 (one window each) give 66 windows per stream, so streams
# still hold their lanes when the last of the 8 arrivals (0.57 s) comes
SERVE_DATA = dict(FLAGSHIP_DATA, mode="time", window=0.01, sliding_window=0.005,
                  sequence=dict(FLAGSHIP_DATA["sequence"], sequence_length=3))
SERVE_ACTIVITY_TILE = 16


def serving_traffic():
    """The serving traffic: classes ``standard:8`` and ``gated:4:0.3``, 8
    streams (4 bursty, 4 uniform) on a Poisson schedule at 8/s, the classes
    dealt in sorted order (the bursty streams are gated)."""
    from esr_tpu_torch.serve import parse_classes
    from esr_tpu_torch.serving.loadgen import make_stream_corpus, poisson_schedule

    classes = parse_classes("standard:8,gated:4:0.3")
    classes = {name: classes[name] for name in sorted(classes)}
    streams = make_stream_corpus(n=8, seed=0, sensor_resolution=(720, 1280),
                                 events_schedule=(60_000, 40_000, 80_000, 50_000),
                                 burst_schedule=(0.35, 1.0), num_frames=2,
                                 rungs=("down8", "down16"))
    schedule = poisson_schedule(streams, rate_hz=8.0, seed=0, classes=tuple(classes))
    return classes, streams, schedule


def http_get(url: str):
    """``(status, body, ms)`` of one GET from this thread, bounded by a
    timeout; an HTTP error status is an answer."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            status, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read().decode()
    return status, body, (time.perf_counter() - t0) * 1e3


def scrape_live(base: str) -> dict:
    """One GET of each live endpoint; fails unless all four answer 200 with
    a well-formed body."""
    from esr_tpu_torch.obs.aggregate import parse_snapshot_wire

    out = {}
    for path in ("/metrics", "/healthz", "/slo", "/snapshot"):
        status, body, ms = http_get(base + path)
        if status != 200:
            fail(f"the live plane's {path} answered {status} mid-run: {body[:500]}")
        out[path] = ms
        if path == "/metrics" and 'esr_span_seconds_count{span="serve_chunk"}' not in body:
            fail("/metrics carries no serve_chunk span family mid-run")
        if path == "/slo" and json.loads(body)["verdict"] != "ok":
            fail(f"/slo mid-run: {body[:500]}")
        if path == "/snapshot":
            snap = parse_snapshot_wire(json.loads(body))
            out["snapshot_records"] = snap["state"].records
            if not snap["state"].records:
                fail("/snapshot mid-run holds no records")
    return out


def drive_serving(torch, server, schedule, base=None, max_wall_s: float = 600.0):
    """``ServingEngine.run``'s loop, through the session API, with one scrape
    of the live plane at ``base`` from this thread after the fourth dispatched
    round; returns ``(summary, scrape)``."""
    t0 = time.perf_counter()
    todo = list(schedule)
    scraped, rounds = None, 0
    while True:
        if time.perf_counter() - t0 > max_wall_s:
            fail(f"serving did not drain in {max_wall_s} s")
        rel = time.perf_counter() - t0
        while todo and todo[0].t <= rel:
            a = todo.pop(0)
            server.submit(a.path, a.request_class, request_id=a.request_id)
        status = server.pump()
        rounds += status == "dispatched"
        if base is not None and scraped is None and rounds >= 4:
            scraped = scrape_live(base)
        if status == "drained":
            if not todo:
                break
            time.sleep(min(max(todo[0].t - (time.perf_counter() - t0), 0.0), 0.005))
    server.flush()
    torch.cuda.synchronize()
    return server.summary(), scraped


def sink_write_cost(tel: str, out_dir: str, steps: int, unit: str, card) -> None:
    """The host cost of a run's records: each record of ``tel`` written
    again through a fresh sink (json, append, flush), once alone and once
    with a ``LiveAggregator`` observing it; printed per record and per
    ``unit`` (``steps`` of them in the run)."""
    from esr_tpu_torch.obs import LiveAggregator, TelemetrySink
    from esr_tpu_torch.obs.report import read_telemetry

    _, records, _ = read_telemetry(tel)
    out = {}
    for tag in ("sink", "sink and observer"):
        sink = TelemetrySink(os.path.join(out_dir, "telemetry_replay.jsonl"))
        if tag != "sink":
            LiveAggregator().attach(sink)
        t0 = time.perf_counter()
        for r in records:
            sink._write(r["type"], r["name"],
                        {k: v for k, v in r.items() if k not in ("t", "type", "name")})
        dt = time.perf_counter() - t0
        sink.close()
        out[tag] = dt
    steps = max(steps, 1)
    print(f"telemetry on {card}: {len(records)} records a run ({len(records) / steps:.1f} a "
          f"{unit}); written again through a sink "
          + ", ".join(f"{tag} {dt / len(records) * 1e6:.2f} us a record, "
                      f"{dt / steps * 1e3:.3f} ms a {unit}" for tag, dt in out.items()))


def phase_serving(torch, np, dev, card, repo: Path, out_dir: str):
    """The serving tier on the sparse flagship: lanes 4, classes standard:8
    and gated:4:0.3, 8 streams (4 bursty, 4 uniform) arriving at 8/s,
    preemption quantum 2; under an active telemetry sink with the live plane
    on, scraped mid-run, and without a sink."""
    from esr_tpu_torch.data.loader import InferenceSequenceLoader
    from esr_tpu_torch.inference.engine import METRIC_KEYS, extract_lane_state, inject_lane_state
    from esr_tpu_torch.obs import TelemetrySink, set_active_sink
    from esr_tpu_torch.obs.report import report_files
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.serving.server import ServingEngine
    from esr_tpu_torch.serving.wire import pack_lane_state, unpack_lane_state

    model = flagship_model(torch, np, dcn_sparse=True)
    t0 = time.perf_counter()
    classes, streams, schedule = serving_traffic()
    n_windows = {s.name: len(InferenceSequenceLoader(s, SERVE_DATA)) for s in streams}
    print(f"serving setup: {time.perf_counter() - t0:.2f} s; windows per stream {n_windows}")
    slo = str(repo / "configs" / "slo.yml")

    def engine(**kw):
        return ServingEngine(model, SERVE_DATA, lanes=LANES, classes=classes,
                             default_class="standard", activity_tile=SERVE_ACTIVITY_TILE,
                             device=dev, **kw)

    def with_sink(tag: str, count: bool = False, live: bool = True):
        """A session under an active sink, with the live plane on port 0
        (scraped mid-run) or without it."""
        path = os.path.join(out_dir, f"telemetry_{tag}.jsonl")
        sink = TelemetrySink(path)
        prev = set_active_sink(sink)
        try:
            server = (engine(preempt_quantum=2, live_port=0, live_slo=slo) if live
                      else engine(preempt_quantum=2))
            if count:
                dcn_cuda.reset_launches()
            summary, scraped = drive_serving(
                torch, server, schedule,
                f"http://127.0.0.1:{server.live.port}" if live else None)
            counts = counts_of()
            server.close_live()
        finally:
            set_active_sink(prev)
            sink.close()
        return server, summary, scraped, counts, path

    engine(preempt_quantum=0).run(schedule[:1])  # warm
    # the main run: under a sink, the live plane scraped mid-run
    server, summary, scraped, counts, tel = with_sink("serving", count=True)
    print("serving summary: " + json.dumps(summary))
    print(f"serving launches {counts}")
    print(f"serving live plane on {card}: scraped mid-run (after 4 dispatched rounds) from "
          f"the main thread, ms per GET " + json.dumps(scraped))
    reports = server.reports()
    if summary["completed"] != len(streams) or any(r["status"] != "ok" for r in reports.values()):
        fail(f"not every request ended done: {summary['statuses']}")
    if counts != only("dcn_fwd_masked", 2 * summary["window_steps"]):
        fail(f"serving launched {counts}, expected only dcn_fwd_masked, 2 per window "
             f"step ({2 * summary['window_steps']})")
    for r in reports.values():
        if r["n_windows"] + r["n_windows_skipped"] != n_windows[r["path"]]:
            fail(f"{r['request_id']}: {r['n_windows']} computed + {r['n_windows_skipped']} "
                 f"skipped != {n_windows[r['path']]} windows")
    gated_skipped = sum(r["n_windows_skipped"] for r in reports.values()
                        if r["request_class"] == "gated")
    if not gated_skipped > 0:
        fail("the gated class skipped no window")
    if not summary["preemptions"] > 0:
        fail("8 streams on 4 lanes at quantum 2 and no preemption")
    doc, code = report_files([tel], slo)
    rep = doc["report"]
    print(f"serving telemetry report ({os.path.basename(tel)}) against configs/slo.yml: exit "
          f"{code}; goodput {rep['goodput']['value']}, traces {rep['traces']}, "
          f"windows {rep['serving']['windows']} + {rep['serving']['windows_skipped']} skipped")
    if code != 0 or rep["serving"]["requests"] != len(streams) or (
            rep["serving"]["windows_skipped"] != summary["windows_skipped"]):
        fail(f"the serving telemetry does not pass configs/slo.yml or disagrees with the "
             f"summary: {json.dumps(doc.get('slo'))}")

    # windows/s with no sink, with a sink alone and with a sink and the live
    # plane, in turns: the first difference is the sink's per-record write
    # and flush, the second the live plane's observer and HTTP thread
    rates = {"sink and live plane": [summary["windows_per_sec"]], "sink": [], "no sink": []}
    for i, tag in enumerate(("no sink", "sink")):
        if tag == "no sink":
            again, _ = drive_serving(torch, engine(preempt_quantum=2), schedule)
        else:
            _, again, _, _, _ = with_sink(f"serving_{i}", live=tag != "sink")
        rates[tag].append(again["windows_per_sec"])
    print(f"serving on {card}, windows/s computed (runs in the order live, none, sink): "
          + json.dumps(rates))
    sink_write_cost(tel, out_dir, summary["window_steps"], "window step", card)

    # every preempted stream against the same stream served alone
    by_name = {s.name: s for s in streams}
    worst = 0.0
    for r in reports.values():
        if not r["preemptions"]:
            continue
        alone = engine(preempt_quantum=0)
        rid = alone.submit(by_name[r["path"]], r["request_class"])
        alone.run()
        a = alone.report(rid)
        if (a["n_windows"], a["n_windows_skipped"]) != (r["n_windows"], r["n_windows_skipped"]):
            fail(f"{r['request_id']} served alone computed/skipped differently")
        for k in METRIC_KEYS:
            worst = max(worst, abs(r[k] - a[k]) / max(abs(a[k]), 1e-12))
    print(f"serving: preempted streams vs served alone, worst relative metric difference "
          f"{worst:.3e} (limit {SERVE_TOL})")
    if not worst <= SERVE_TOL:
        fail("a preempted stream's metrics differ from the same stream served alone")

    # ESRLANE1 round trip of a lane state, bitwise
    states = server._states
    host = extract_lane_state(states, 1)
    back = unpack_lane_state(pack_lane_state(host), host)
    copy_states = tuple(z.clone() for z in states)
    copy_states = inject_lane_state(tuple(torch.zeros_like(z) for z in copy_states), 1, back)
    if not all(same_bits(torch, a[1], b[1]) for a, b in zip(copy_states, states)):
        fail("the lane state did not survive extract -> pack -> unpack -> inject bitwise")
    print("serving: extract -> pack -> unpack -> inject of a lane state is bitwise")
    for name, c in summary["classes"].items():
        print(f"serving class {name} on {card}: window latency p50 {c['p50_window_ms']} ms, "
              f"p99 {c['p99_window_ms']} ms over {c['windows']} windows")
    print(f"serving on {card}: {summary['windows_per_sec']} windows/s computed, "
          f"{summary['served_windows_per_sec']} served; {summary['preemptions']} preemptions; "
          f"{counts['dcn_fwd_masked']} dcn_fwd_masked launches")
    return counts["dcn_fwd_masked"], summary


def phase_fleet(torch, np, dev, card, repo: Path, out_dir: str):
    """The serving fleet: the serving traffic as a burst through one
    fault-free twin engine, then through 3 replicas on the card behind
    ``FleetRouter`` under ``build_fleet_plan(0)`` (router_handoff,
    replica_kill, replica_partition), the fleet view on
    (``resilience.chaos_fleet.run_fleet_scenario``); then the entry point,
    ``serve --replicas 3 --fleet-port 0`` on its default device."""
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.resilience.chaos_fleet import N_REPLICAS, run_fleet_scenario

    model = flagship_model(torch, np, dcn_sparse=True)
    classes, streams, _ = serving_traffic()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    twin_counts = {}

    def between_halves():
        # the twin's launches, read as its run ends; then the fleet's own
        # count starts from 0
        torch.cuda.synchronize()
        twin_counts.update(counts_of())
        dcn_cuda.reset_launches()

    dcn_cuda.reset_launches()
    t0 = time.perf_counter()
    result = run_fleet_scenario(out_dir, model, streams, SERVE_DATA, classes, seed=0,
                                lanes=LANES, activity_tile=SERVE_ACTIVITY_TILE, device=dev,
                                between=between_halves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_of()
    summary, twin = result["summary"], result["twin_summary"]
    print(f"fleet: {N_REPLICAS} replicas x {LANES} lanes on one card, {len(streams)} streams; "
          f"scenario {wall:.2f} s; statuses {summary['statuses']}, replicas "
          f"{summary['replicas']}, rounds {summary['rounds']}")
    print("fleet checks: " + json.dumps(result["checks"]))
    print(f"fleet faults: {json.dumps(result['faults'])}; streams the kill left to fail over "
          f"{result['killed_streams']}")
    print(f"fleet vs twin: worst relative metric difference {result['parity']['max_rel_diff']:.3e} "
          f"at {result['parity']['at']} over {result['parity']['compared']} streams "
          f"(limit 1e-5), window counts equal {result['parity']['windows_match']}")
    fleet_launches = counts["dcn_fwd_masked"]
    print(f"fleet launches, each half counted in its own run: the twin {twin_counts} "
          f"({twin['window_steps']} window steps), the fleet {counts}")
    if twin_counts != only("dcn_fwd_masked", twin_counts.get("dcn_fwd_masked", 0)) or \
            twin_counts["dcn_fwd_masked"] <= 0:
        fail(f"the twin launched {twin_counts}: expected dcn_fwd_masked only, at least once")
    if counts != only("dcn_fwd_masked", fleet_launches) or fleet_launches <= 0:
        fail(f"the fleet launched {counts}: expected dcn_fwd_masked only, at least once")
    for rid, mem in result["abandoned_memory"].items():
        print(f"fleet: replica {rid} abandoned, torch.cuda.memory_allocated {mem[0]} -> "
              f"{mem[1]} bytes")
    print(f"fleet: card memory allocated before the phase {mem0}, after "
          f"{torch.cuda.memory_allocated()} bytes")
    for name, c in result["classes"].items():
        print(f"fleet class {name} on {card}: window latency p50 {c['window_latency_p50_ms']} "
              f"ms, p99 {c['window_latency_p99_ms']} ms over {c['windows']} windows "
              "(merged router + replica telemetry)")
    print(f"fleet on {card}: {summary['windows_per_sec']} windows/s over the fleet run "
          f"against the twin's {twin['windows_per_sec']} (computed); handoffs "
          f"{summary['migrations']}, fail-overs {summary['failovers']}; supervisor /snapshot "
          f"fetch p50 {result['supervision']['fetch_ms_p50']} ms over "
          f"{result['supervision']['fetches']} fetches; {fleet_launches} dcn_fwd_masked "
          "launches")
    if not result["ok"]:
        fail("the fleet phase failed: " + json.dumps(
            {k: v for k, v in result["checks"].items() if not v}))
    fleet_entry_point(model, repo, os.path.join(out_dir, "entry"))
    return fleet_launches, result


def fleet_entry_point(model, repo: Path, root: str) -> None:
    """``esr_tpu_torch.serve.main --replicas 3 --fleet-port 0`` (the card by
    default) on 4 load-generated streams, from a port checkpoint of the
    sparse flagship: every request ok, the reference's fleet files written,
    and the merged telemetry green against ``configs/slo.yml``."""
    import logging

    from esr_tpu_torch import serve
    from esr_tpu_torch.inference.checkpoint import save_checkpoint
    from esr_tpu_torch.models import convert
    from esr_tpu_torch.obs.report import report_files

    ckpt = os.path.join(root, "ckpt")
    save_checkpoint(ckpt, convert.export_flax_params(model), {
        "model": {"name": "DeepRecurrNet",
                  "args": {"inch": 2, "basech": model.basech, "num_frame": 3,
                           "dcn_sparse": True}}})
    out = os.path.join(root, "serve")
    slo = str(repo / "configs" / "slo.yml")
    level = logging.getLogger().level
    try:
        summary = serve.main(["--model_path", ckpt, "--output_path", out, "--loadgen", "4",
                              "--rate", "50", "--lanes", "4", "--replicas", "3",
                              "--fleet-port", "0", "--live-slo", slo, "--scale", "2",
                              "--ori_scale", "down8", "--window", "1024", "--sliding_window",
                              "512", "--seql", "4", "--max_wall", "300"])
    finally:
        logging.getLogger().setLevel(level)  # serve.main sets INFO
    names = ["telemetry_router.jsonl"] + [f"telemetry_r{i}.jsonl" for i in range(3)]
    doc, code = report_files([os.path.join(out, n) for n in names], slo)
    with open(os.path.join(out, "fleet_requests.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    view = summary.get("fleet_view") or {}
    print(f"serve --replicas 3 --fleet-port 0: statuses {summary['statuses']}, replicas "
          f"{summary['replicas']}, {summary['windows']} windows; fleet_requests.jsonl "
          f"{len(rows)} rows; merged telemetry vs configs/slo.yml exit {code}; the fleet "
          f"view merged {view.get('merged')}")
    if (not summary["zero_lost"] or summary["statuses"] != {"ok": 4} or len(rows) != 4
            or code != 0 or not os.path.isfile(os.path.join(out, "fleet_summary.json"))
            or not {"r0", "r1", "r2"} <= set(view.get("merged", []))):
        fail("serve --replicas 3 did not serve every stream, write the fleet's files or "
             "pass configs/slo.yml")


AOT_DEPTHS = (8, 4)  # the serving classes' chunk_windows (standard, gated)
AOT_RUNGS = ("f32", "int8", "bf16")
# the depths exported at each rung: bf16 at the standard class's only (its
# session serves every stream in that class), to keep the phase short
AOT_RUNG_DEPTHS = {"f32": AOT_DEPTHS, "int8": AOT_DEPTHS, "bf16": (8,)}
AOT_ROUND_S = 0.05  # the replayed schedule's virtual seconds per round
# the SR recipe's artifacts: the standard class's depth, at f32 and int8
SR_AOT_DEPTH = 8
SR_AOT_RUNGS = ("f32", "int8")


def drive_replay(server, schedule, round_s: float = AOT_ROUND_S):
    """The serving schedule replayed on a virtual clock: before round ``r``
    every arrival with ``t <= r * round_s`` is submitted, so two sessions
    see the same arrivals at the same rounds and bind, preempt and chunk
    alike (the wall clock decides nothing). Returns the summary and the
    seconds from the first round to the first chunk's readback (the
    program's build or load included)."""
    todo = sorted(schedule, key=lambda a: a.t)
    rounds, first = 0, None
    t0 = time.perf_counter()
    while True:
        while todo and todo[0].t <= rounds * round_s:
            a = todo.pop(0)
            server.submit(a.path, a.request_class, request_id=a.request_id)
        status = server.pump()
        rounds += 1
        if first is None and server._last_resolve_t is not None:
            first = time.perf_counter() - t0
        if status == "drained" and not todo:
            break
        if rounds > 100_000:
            fail("the replayed serving session did not drain")
    server.flush()
    if first is None:
        first = time.perf_counter() - t0
    return server.summary(), first


def aot_session(torch, model, dev, rung, classes, arrivals, programs=None):
    """One replayed serving session at ``rung`` on the card, traced or
    through ``programs`` (``aot_programs``); the launches counted from 0."""
    from esr_tpu_torch.ops import int8_cuda
    from esr_tpu_torch.serving.server import ServingEngine

    server = ServingEngine(model, SERVE_DATA, lanes=LANES, classes=classes,
                           default_class="standard", activity_tile=SERVE_ACTIVITY_TILE,
                           preempt_quantum=2, precision=rung, device=dev,
                           aot_programs=programs)
    reset_all_launches()
    summary, first_s = drive_replay(server, arrivals)
    torch.cuda.synchronize()
    counts = {**counts_of(), **{k.name: k.launches for k in int8_cuda.KERNELS}}
    return server, summary, first_s, counts


def aot_vs_traced(torch, model, dev, card, rung, artifacts, classes, schedule, what):
    """The serving schedule replayed through a traced session and through
    the depths ``artifacts`` (``{w: path}``) at ``rung``; arrivals of a class
    without an artifact go to the standard class. Every request's metrics,
    windows, skips and preemptions and the final lane states bitwise, the
    same launches. Returns the AOT session's summary, its launches and its
    programs' load seconds."""
    from esr_tpu_torch.inference.engine import METRIC_KEYS

    kept = {n: c for n, c in classes.items() if c.chunk_windows in artifacts}
    arrivals = [a if a.request_class in kept
                else dataclasses.replace(a, request_class="standard") for a in schedule]
    traced, t_sum, t_first, t_counts = aot_session(torch, model, dev, rung, kept, arrivals)
    aot, a_sum, a_first, a_counts = aot_session(torch, model, dev, rung, kept, arrivals,
                                                artifacts)
    reports_t, reports_a = traced.reports(), aot.reports()
    n = len({a.request_id for a in schedule})
    if t_sum["completed"] != n or a_sum["completed"] != n:
        fail(f"aot {what} {rung}: not every request completed ({t_sum['statuses']}, "
             f"{a_sum['statuses']})")
    for rid, r in reports_t.items():
        a = reports_a[rid]
        keys = ("n_windows", "n_windows_skipped", "preemptions", "status")
        if any(r[k] != a[k] for k in keys) or any(r[k] != a[k] for k in METRIC_KEYS):
            fail(f"aot {what} {rung}: request {rid} differs from the traced session: "
                 f"{ {k: (r[k], a[k]) for k in keys + METRIC_KEYS if r[k] != a[k]} }")
    if not all(same_bits(torch, x.float(), y.float())
               for x, y in zip(traced._states, aot._states)):
        fail(f"aot {what} {rung}: the final lane states differ from the traced session's")
    if t_counts != a_counts:
        fail(f"aot {what} {rung}: launches {a_counts} against the traced session's "
             f"{t_counts}")
    print(f"aot serving {what} {rung}: {len(reports_a)} requests bitwise the traced session "
          f"(metrics, windows, skips, preemptions) and the final lane states bitwise "
          f"({len(aot._states)} leaves); launches {a_counts}, the traced session's the same")
    for tag, summ, first, srv in (("traced", t_sum, t_first, traced),
                                  ("aot", a_sum, a_first, aot)):
        cls = {n: (c["p50_window_ms"], c["p99_window_ms"])
               for n, c in summ["classes"].items()}
        # an AOT session's program time is the artifact's load with the
        # serving weights (sidecar checks, deserialization, weights in)
        print(f"aot serving {what} {rung} {tag} on {card}: first chunk read back "
              f"{first * 1e3:.1f} ms after the first round; programs "
              f"{ {w: round(v * 1e3, 1) for w, v in srv.program_seconds.items()} } ms "
              f"({'load' if tag == 'aot' else 'build'}); window p50 "
              f"{summ['p50_window_ms']} ms, p99 "
              f"{summ['p99_window_ms']} ms, per class (p50, p99) {cls}; "
              f"{summ['windows_per_sec']} windows/s computed")
    return a_sum, a_counts, aot.program_seconds


def srunet_spec(repo: Path) -> dict:
    """The second shipped recipe's ``model`` section, as written."""
    from esr_tpu_torch.config.parser import load_config

    return load_config(str(repo / "configs" / "train_srunet_2x.yml"))["model"]


def phase_aot(torch, np, dev, card, repo: Path, out_dir: str, sr_dir: str):
    """The AOT export on the sparse flagship at lanes 4: the chunk programs
    of depths 8 and 4 at f32 and int8, and of depth 8 at bf16, exported
    from a port checkpoint (``inference.export.export_checkpoint``,
    ``program="engine_chunk"``), loaded back, and the serving phase's 8
    streams (at bf16 all in the standard class) served through
    ``aot_programs`` against a traced session on the same replayed schedule:
    every request's metrics and the final lane states bitwise, the same
    launches (``dcn_fwd_masked``; K1 and K2 at int8), which the loaded
    artifacts make through the custom ops. Then ``serve --aot``, one replica
    and ``--replicas 2`` (through ``AotRegistry``). With them, a process
    each and all at once, the SR recipe's chunk programs of depth 8 at f32
    and int8 (:data:`SR_AOT_RUNGS`), exported into ``sr_dir`` from a
    checkpoint of its model with seeded weights (an artifact takes the
    serving model's weights when it loads): returned, ``{rung: {8: path}}``,
    for phase 8e to serve the trained checkpoint through."""
    from esr_tpu_torch.inference.checkpoint import save_checkpoint
    from esr_tpu_torch.models import convert
    from esr_tpu_torch.models.registry import get_model
    from esr_tpu_torch.serving.server import RecordingStream

    model = flagship_model(torch, np, dcn_sparse=True)
    classes, streams, schedule = serving_traffic()
    ckpt = os.path.join(out_dir, "ckpt")
    save_checkpoint(ckpt, convert.export_flax_params(model), {
        "model": {"name": "DeepRecurrNet",
                  "args": {"inch": 2, "basech": model.basech, "num_frame": 3,
                           "dcn_sparse": True}}})
    spec = srunet_spec(repo)
    torch.manual_seed(0)
    sr_ckpt = os.path.join(sr_dir, "ckpt")
    save_checkpoint(sr_ckpt, convert.export_flax_params(get_model(spec["name"], **spec["args"])),
                    {"model": spec})
    probe = RecordingStream(streams[0], SERVE_DATA)
    kh, kw = probe.gt_resolution
    if tuple(probe.inp_resolution) != (kh // SERVE_DATA["scale"], kw // SERVE_DATA["scale"]):
        fail(f"serving grids {probe.inp_resolution} -> {probe.gt_resolution} are not a "
             f"x{SERVE_DATA['scale']} pair")
    if sorted({c.chunk_windows for c in classes.values()}) != sorted(AOT_DEPTHS):
        fail(f"the serving classes' depths are not {AOT_DEPTHS}")

    def job(path, rung, w, root, tag):
        return {"ckpt_path": path, "batch": LANES, "height": kh, "width": kw,
                "program": "engine_chunk", "chunk_windows": w, "scale": SERVE_DATA["scale"],
                "precision": rung,
                "out_path": os.path.join(root, "aot", f"chunk_program.{tag}{rung}.w{w}.pt2")}

    jobs = {("flagship", rung, w): job(ckpt, rung, w, out_dir, "")
            for rung in AOT_RUNGS for w in AOT_RUNG_DEPTHS[rung]}
    jobs.update({("srunet", rung, SR_AOT_DEPTH): job(sr_ckpt, rung, SR_AOT_DEPTH, sr_dir,
                                                      "srunet.")
                 for rung in SR_AOT_RUNGS})
    t0 = time.perf_counter()
    seconds = export_in_processes(repo, jobs)
    print(f"aot exports on {card}: {len(jobs)} at once, a process each, in "
          f"{time.perf_counter() - t0:.2f} s")
    artifacts, table = {}, {}
    for (what, rung, w), j in jobs.items():
        path = j["out_path"]
        artifacts.setdefault(what, {}).setdefault(rung, {})[w] = path
        table[what, rung, w] = {"export_s": seconds[what, rung, w],
                                "bytes": os.path.getsize(path)}
        print(f"aot export {what} {rung} w{w} (lanes {LANES}, GT {kh}x{kw}) on {card}: "
              f"{seconds[what, rung, w]:.2f} s (beside the other exports), "
              f"{os.path.getsize(path)} bytes (+ sidecar {os.path.getsize(path + '.json')})")

    aot_session(torch, model, dev, "f32", classes, schedule[:1])  # warm: cuDNN's algorithms
    for rung in AOT_RUNGS:
        a_sum, counts, loads = aot_vs_traced(torch, model, dev, card, rung,
                                             artifacts["flagship"][rung], classes, schedule,
                                             "flagship")
        want = 2 * a_sum["window_steps"]
        k12 = (counts["int8_conv"], counts["quantize_per_tensor"])
        if counts["dcn_fwd_masked"] != want or (rung == "int8") != (min(k12) > 0):
            fail(f"aot {rung}: launches {counts} (dcn_fwd_masked {want} expected, K1/K2 at "
                 "int8 only)")
        for w, secs in loads.items():
            table["flagship", rung, w]["load_ms"] = secs * 1e3
    print(f"aot artifacts on {card} (lanes {LANES}): " + "; ".join(
        f"{what} {rung} w{w} export {r['export_s']:.2f} s, {r['bytes']} bytes"
        + (f", load {r['load_ms']:.1f} ms" if "load_ms" in r else "")
        for (what, rung, w), r in table.items()))
    aot_entry_point(model, repo, os.path.join(out_dir, "entry"))
    return artifacts["srunet"]


def export_in_processes(repo: Path, jobs: dict) -> dict:
    """``inference.export.export_checkpoint(**job)`` for every job at once,
    each in a process of its own on the card (a trace is one core's work);
    each job's seconds. Fails, and ends the others, if one fails."""
    code = ("import json, sys, time\n"
            "from esr_tpu_torch.inference.export import export_checkpoint\n"
            "t0 = time.perf_counter()\n"
            "export_checkpoint(**json.loads(sys.argv[1]))\n"
            "print(time.perf_counter() - t0)\n")
    procs = {key: subprocess.Popen([sys.executable, "-c", code, json.dumps(job)],
                                   cwd=str(repo), stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for key, job in jobs.items()}
    seconds = {}
    try:
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                fail(f"aot export {key}: exit {proc.returncode}: {err[-2000:]}")
            seconds[key] = float(out.split()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return seconds


# ``serve.main --aot`` in a process of its own: its summary and its
# process's launch counts on the last line
AOT_ENTRY_CODE = (
    "import json, sys, time\n"
    "from esr_tpu_torch import serve\n"
    "from esr_tpu_torch.ops import dcn_cuda\n"
    "t0 = time.perf_counter()\n"
    "summary = serve.main(json.loads(sys.argv[1]))\n"
    "counts = {k.name: k.launches for k in dcn_cuda.KERNELS}\n"
    "print(json.dumps({'summary': summary, 'counts': counts,\n"
    "                  'wall': time.perf_counter() - t0}, default=str))\n")


def aot_entry_point(model, repo: Path, root: str) -> None:
    """``esr_tpu_torch.serve.main --aot`` (the card by default) on 4
    load-generated streams, one replica and ``--replicas 2`` (each replica
    resolves its program through an ``AotRegistry``), at once, a process
    each: every request ok, no request lost, the artifact and its sidecar
    written, the loaded program's ``dcn_fwd_masked`` launched."""
    from esr_tpu_torch.inference.checkpoint import save_checkpoint
    from esr_tpu_torch.models import convert

    ckpt = os.path.join(root, "ckpt")
    save_checkpoint(ckpt, convert.export_flax_params(model), {
        "model": {"name": "DeepRecurrNet",
                  "args": {"inch": 2, "basech": model.basech, "num_frame": 3,
                           "dcn_sparse": True}}})
    slo = str(repo / "configs" / "slo.yml")

    def argv(replicas):
        return ["--model_path", ckpt, "--output_path", os.path.join(root, f"serve_r{replicas}"),
                "--loadgen", "4", "--rate", "50", "--lanes", "4", "--replicas", str(replicas),
                "--aot", "--classes", "standard:4", "--default_class", "standard",
                "--live-slo", slo, "--scale", "2", "--ori_scale", "down8", "--window", "1024",
                "--sliding_window", "512", "--seql", "4", "--max_wall", "300"]

    t0 = time.perf_counter()
    procs = {r: subprocess.Popen([sys.executable, "-c", AOT_ENTRY_CODE, json.dumps(argv(r))],
                                 cwd=str(repo), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True) for r in (1, 2)}
    try:
        for replicas, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                fail(f"serve --aot --replicas {replicas}: exit {proc.returncode}: {err[-2000:]}")
            print(out.rstrip())
            got = json.loads(out.strip().splitlines()[-1])
            summary, counts = got["summary"], got["counts"]
            art = os.path.join(root, f"serve_r{replicas}", "aot", "chunk_program.w4.pt2")
            ok = (summary["statuses"] == {"ok": 4} and os.path.isfile(art)
                  and os.path.isfile(art + ".json") and counts["dcn_fwd_masked"] > 0
                  and all(v == 0 for k, v in counts.items() if k != "dcn_fwd_masked"))
            if replicas > 1:
                ok = ok and summary["zero_lost"]
            print(f"serve --aot --replicas {replicas}: statuses {summary['statuses']}, "
                  f"{summary['windows']} windows, launches {counts}, "
                  + (f"zero lost {summary['zero_lost']}, " if replicas > 1 else "")
                  + f"{got['wall']:.1f} s with the export, in its own process")
            if not ok:
                fail(f"serve --aot --replicas {replicas} did not serve every stream through "
                     "its artifact")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"serve --aot: one replica and two, at once, in {time.perf_counter() - t0:.1f} s")


def int8_seam_calls(torch, model, dev, batch: int, kh: int, kw: int):
    """The contraction seams one flagship window runs at batch ``batch``, in
    order: ``(module, NCHW input shape, out-channels, kernel, stride,
    padding)`` (a dense as a 1x1 conv)."""
    from esr_tpu_torch.config.quantize import int8_scope
    from esr_tpu_torch.models.layers import Conv2d, Linear

    calls, hooks = [], []
    for mod in model.modules():
        if isinstance(mod, Conv2d):
            hooks.append(mod.register_forward_pre_hook(lambda m, a: calls.append(
                (m, tuple(a[0].shape), m.out_channels, m.kernel_size[0], m.stride[0],
                 m.padding[0]))))
        elif isinstance(mod, Linear):
            hooks.append(mod.register_forward_pre_hook(lambda m, a: calls.append(
                (m, tuple(a[0].shape) + (1, 1), m.out_features, 1, 1, 0))))
    try:
        with torch.no_grad(), int8_scope():
            model(torch.rand(batch, 3, kh, kw, 2, device=dev),
                  model.init_states(batch, kh, kw, device=dev))
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return calls


def int8_roofline(nbytes_: float, ops: float):
    t_bytes = nbytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def graph_ms(torch, fn, n: int = 20) -> float:
    """Device time of one call of ``fn`` inside a CUDA graph of ``n`` calls
    (captured once and replayed: no host launch in the timing). ``fn``
    launches on the current stream, which the capture sets."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    torch.cuda.synchronize()
    return time_ms(torch, graph.replay, iters=20, warmup=3) / n


def int8_kernel_shapes(torch, np, dev, card, model, kh, kw):
    """K1 and K2 against their plain versions, bitwise and twice (bitwise
    run to run), at every distinct seam shape of one flagship window at B=1
    and at lanes 4; each shape's launch plan; their times through the op
    and the C entry point (the log line adds the previous design's,
    :data:`EARLIER_INT8_MS`), their device time a call inside a CUDA graph
    (which also proves both capturable: the graph's outputs are checked), the
    bound, an empty kernel's launch (the floor), the plain version and
    ``torch._int_mm`` over an im2col (the GEMM alone) where it takes the
    shape."""
    import torch.nn.functional as F

    from esr_tpu_torch.ops import int8_cuda

    lib = int8_cuda.INT8_LIBRARY.load()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    floor_ms = time_ms(torch, lambda: lib.empty_launch(stream()), iters=200)
    floor_graph_ms = graph_ms(torch, lambda: lib.empty_launch(stream()))
    print(f"int8 launch floor on {card}: an empty kernel's launch {floor_ms:.5f} ms through "
          f"its C entry point, {floor_graph_ms:.5f} ms inside a CUDA graph")
    rows = []
    for batch in (1, LANES):
        calls = int8_seam_calls(torch, model, dev, batch, kh, kw)
        distinct = {}
        for mod, shape, cout, k, stride, pad in calls:
            distinct.setdefault((shape, cout, k, stride, pad), [mod, 0])[1] += 1
        print(f"int8 seams at batch {batch}: {len(calls)} calls a window, "
              f"{len(distinct)} distinct shapes")
        for (shape, cout, k, stride, pad), (mod, n_calls) in distinct.items():
            x = torch.randn(shape, device=dev)
            w = mod.weight.detach()
            packed = int8_cuda.pack_weight(w if w.dim() == 4 else w[:, :, None, None])
            bias = mod.bias.detach()
            runs = []
            for _ in range(2):
                xq, sx = int8_cuda.quantize_per_tensor(x)
                runs.append((xq, sx, int8_cuda.int8_conv(xq, sx, packed, bias, stride, pad)))
            xq, sx, out = runs[0]
            pq, psx = int8_cuda.quantize_per_tensor_plain(x)
            ref = int8_cuda.int8_conv_plain(pq, psx, packed, bias, stride, pad)
            torch.cuda.synchronize()
            if not (torch.equal(xq, pq) and same_bits(torch, sx, psx)):
                fail(f"quantize_per_tensor differs from its plain version at {shape}")
            if not same_bits(torch, out, ref):
                fail(f"int8_conv differs from its plain version at {shape} -> {cout}, k {k}")
            if not (torch.equal(runs[1][0], xq) and same_bits(torch, runs[1][1], sx)
                    and same_bits(torch, runs[1][2], out)):
                fail(f"K1 or K2 is not bitwise run to run at {shape} -> {cout}, k {k}")
            b, cin, h, wd = shape
            ho, wo = out.shape[2:]
            m_rows, kk = b * ho * wo, k * k * cin
            np_, kp = packed.wq.shape
            plan = int8_cuda.conv_plan(m_rows, cout, kp, xq.shape[-1])
            k2_blocks = int8_cuda.quantize_blocks(int8_cuda.quantize_items(x.shape))
            k1_ms = time_ms(torch, lambda: int8_cuda.int8_conv(xq, sx, packed, bias, stride,
                                                               pad), iters=50)
            k2_ms = time_ms(torch, lambda: int8_cuda.quantize_per_tensor(x), iters=50)
            k2_plain_ms = time_ms(torch, lambda: int8_cuda.quantize_per_tensor_plain(x),
                                  iters=5, warmup=2)
            # the C entry points alone (not counted): no wrapper checks or
            # allocations
            out_e, q_e = torch.empty_like(out), torch.empty_like(xq)
            s_e = torch.empty_like(sx)
            partials = int8_cuda.quantize_per_tensor.partials(dev, stream())

            def k1_entry():
                rc = lib.int8_conv_f32(
                    xq.data_ptr(), packed.wq.data_ptr(), sx.data_ptr(), packed.scale.data_ptr(),
                    bias.data_ptr(), out_e.data_ptr(), shape[0], shape[2], shape[3],
                    xq.shape[-1], out.shape[2], out.shape[3], cout, np_, kp, k, k, stride, pad,
                    1, plan.wm, plan.wn, plan.nt, plan.mt, plan.split, plan.chunk, stream())
                if rc:
                    fail(f"int8_conv_f32 returned {rc} at {shape}")

            def k2_entry():
                rc = lib.quantize_per_tensor_f32(
                    x.data_ptr(), shape[0], shape[1], shape[2] * shape[3], xq.shape[-1],
                    q_e.data_ptr(), s_e.data_ptr(), partials.data_ptr(), k2_blocks,
                    stream())
                if rc:
                    fail(f"quantize_per_tensor_f32 returned {rc} at {shape}")
            k1_entry_ms = time_ms(torch, k1_entry, iters=50)
            k2_entry_ms = time_ms(torch, k2_entry, iters=50)
            torch.cuda.synchronize()
            if not (same_bits(torch, out_e, out) and torch.equal(q_e, xq)):
                fail(f"the int8 entry points disagree with their wrappers at {shape}")
            out_e.zero_()
            q_e.zero_()
            k1_graph_ms = graph_ms(torch, k1_entry)
            k2_graph_ms = graph_ms(torch, k2_entry)
            torch.cuda.synchronize()
            if not (same_bits(torch, out_e, out) and torch.equal(q_e, xq)):
                fail(f"K1 or K2 replayed from a CUDA graph disagrees at {shape}")
            plain_ms = time_ms(torch, lambda: int8_cuda.int8_conv_plain(
                pq, psx, packed, bias, stride, pad), iters=5, warmup=2)
            k1_bound = int8_roofline(xq.numel() + cout * kk + 8 * cout + 4 * out.numel(),
                                     2.0 * m_rows * cout * kk)
            k2_bound = int8_roofline(4 * x.numel() + xq.numel(), 0.0)
            # the library's int8 GEMM over an im2col of the same int8 values
            # (K and N padded to its multiple of 8)
            cols = F.unfold(pq[..., :cin].permute(0, 3, 1, 2).float(), k, padding=pad,
                            stride=stride)
            a = cols.transpose(1, 2).reshape(m_rows, kk)
            a = F.pad(a, (0, -kk % 8)).round().to(torch.int8).contiguous()
            bmat = F.pad(packed.q.reshape(cout, kk).float(), (0, -kk % 8, 0, 0))
            bmat = F.pad(bmat.t(), (0, -cout % 8)).to(torch.int8).contiguous()
            try:
                lib_ms = time_ms(torch, lambda: torch._int_mm(a, bmat), iters=50)
            except RuntimeError as e:
                lib_ms = None
                lib_refusal = str(e).splitlines()[0][:80]
            earlier = EARLIER_INT8_MS.get((batch, tuple(shape), cout, k, stride))
            row = dict(batch=batch, shape=list(shape), cout=cout, k=k, stride=stride,
                       calls_per_window=n_calls, M=m_rows, N=cout, K=kk, Kp=int(kp),
                       plan=dict(bm=plan.bm, bn=plan.bn, split=plan.split, chunk=plan.chunk,
                                 grid=list(plan.grid(m_rows, cout))),
                       k2_blocks=k2_blocks,
                       ms=k1_ms, k2_ms=k2_ms, entry_ms=k1_entry_ms, k2_entry_ms=k2_entry_ms,
                       graph_ms=k1_graph_ms, k2_graph_ms=k2_graph_ms,
                       launch_floor_ms=floor_ms, k2_plain_ms=k2_plain_ms,
                       plain_ms=plain_ms, bound_ms=k1_bound[0], bound_by=k1_bound[1],
                       k2_bound_ms=k2_bound[0], library_ms=lib_ms)
            rows.append(row)
            # the previous design's recorded times, on this log line only (not
            # measured here)
            was = (f" (previous design, recorded: op {earlier[0]:.5f} / entry "
                   f"{earlier[1]:.5f})"
                   if earlier else "")
            was2 = (f" (previous design, recorded: op {earlier[2]:.5f} / entry "
                    f"{earlier[3]:.5f})"
                    if earlier else "")
            print(f"int8 batch {batch} {list(shape)} -> {cout} k{k} s{stride} (x{n_calls}): "
                  f"M {m_rows} N {cout} K {kk} (Kp {kp}); plan {plan.bm}x{plan.bn} tiles, "
                  f"split {plan.split}, grid {plan.grid(m_rows, cout)}, A copies of "
                  f"{plan.chunk} B; int8_conv op {k1_ms:.5f} / entry {k1_entry_ms:.5f} / "
                  f"graph {k1_graph_ms:.5f} ms{was}, bound {k1_bound[0]:.6f} "
                  f"({k1_bound[1]}); quantize_per_tensor (a cooperative grid of "
                  f"{k2_blocks} blocks) op {k2_ms:.5f} / entry "
                  f"{k2_entry_ms:.5f} / graph {k2_graph_ms:.5f} ms{was2}, bound "
                  f"{k2_bound[0]:.6f} (bytes); floor {floor_ms:.5f}; plain {plain_ms:.5f} ms; "
                  + (f"torch._int_mm {lib_ms:.5f} ms" if lib_ms is not None
                     else f"torch._int_mm refuses: {lib_refusal}")
                  + f"; bitwise, twice; on {card}")
    return rows


def rung_window_metrics(torch, runner, recording, dev):
    """Per-window ESR PSNR and SSIM, latency and prediction of one recording
    through a runner at its rung (the harness's metrics)."""
    from esr_tpu_torch.data.loader import InferenceSequenceLoader
    from esr_tpu_torch.inference.harness import _metrics
    from esr_tpu_torch.ops.resize import interpolate

    loader = InferenceSequenceLoader(recording, FLAGSHIP_DATA)
    kh, kw = loader.gt_resolution
    states = runner.model.init_states(1, kh, kw, device=dev)
    if runner.compute_dtype is not None:
        states = tuple(z.to(runner.compute_dtype) for z in states)
    psnr, ssim, lat, preds = [], [], [], []
    with torch.no_grad():
        for batch in loader:
            inp = torch.from_numpy(batch["inp_scaled_cnt"][:, :3]).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred, states = runner.forward(inp, states)
            pred = pred.float()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            pred0 = pred[0]
            if tuple(pred0.shape[:2]) != (kh, kw):
                pred0 = interpolate(pred0, (kh, kw), "bicubic")
            gt = torch.from_numpy(batch["gt_cnt"][0, 1]).to(dev)
            inp_cnt = torch.from_numpy(batch["inp_cnt"][0, 1]).to(dev)
            m = _metrics(pred0, interpolate(inp_cnt, (kh, kw), "bicubic"), gt)
            if not all(math.isfinite(float(v)) for v in m.values()):
                fail(f"{runner.precision}: non-finite metrics {m}")
            psnr.append(float(m["esr_psnr"]))
            ssim.append(float(m["esr_ssim"]))
            preds.append(pred0)
    return psnr, ssim, lat, preds


# the int8 kernels' names in a profile: K1, then K2
INT8_KERNEL_NAMES = ("int8_igemm_kernel", "quantize_kernel")


def rung_window_profile(torch, runner, recording, dev, card):
    """Device time of one flagship window at the runner's rung, by kernel
    (the int8 kernels' share named)."""
    from torch.profiler import ProfilerActivity, profile

    from esr_tpu_torch.data.loader import InferenceSequenceLoader

    loader = InferenceSequenceLoader(recording, FLAGSHIP_DATA)
    kh, kw = loader.gt_resolution
    inp = torch.from_numpy(next(iter(loader))["inp_scaled_cnt"][:, :3]).to(dev)
    states = runner.model.init_states(1, kh, kw, device=dev)
    if runner.compute_dtype is not None:
        states = tuple(z.to(runner.compute_dtype) for z in states)
    with torch.no_grad():
        runner.forward(inp, states)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runner.forward(inp, states)
            torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if e.device_type == cuda and dev_us(e) > 0]
    busy = device_union_ms(torch, prof)
    named = {}
    for part in INT8_KERNEL_NAMES + ("dcn_forward_kernel", "Memset"):
        hits = [e for e in events if part in e.key]
        named[part] = (sum(dev_us(e) for e in hits) / 1e3, sum(e.count for e in hits))
    print(f"window profile {runner.precision} on {card}: device busy {busy:.4f} ms; "
          + "; ".join(f"{k} {ms:.4f} ms in {n} launches" for k, (ms, n) in named.items() if n))
    return busy, named


def rung_entry_points(torch, np, dev, model, recording, want_psnr):
    """The rungs through the entry points' functions: the flagship's weights
    saved as a port checkpoint whose ``trainer.precision`` is bf16, then
    ``run_inference`` (what ``infer`` calls) with no precision (the
    checkpoint's bf16) and with ``int8`` (the CLI over the checkpoint), each
    within 1e-5 of the harness's mean PSNR at that rung; and
    ``esr_tpu_torch.serve.main --precision int8`` on two load-generated
    streams: both done, through the int8 kernels."""
    import logging

    from esr_tpu_torch import serve
    from esr_tpu_torch.inference.checkpoint import save_checkpoint
    from esr_tpu_torch.inference.harness import run_inference
    from esr_tpu_torch.models import convert
    from esr_tpu_torch.ops import int8_cuda

    root = tempfile.mkdtemp(prefix="chip_smoke_rungs_")
    level = logging.getLogger().level
    try:
        ckpt = os.path.join(root, "ckpt")
        save_checkpoint(ckpt, convert.export_flax_params(model), {
            "model": {"name": "DeepRecurrNet",
                      "args": {"inch": 2, "basech": model.basech, "num_frame": 3}},
            "trainer": {"precision": "bf16"}})
        for cli, rung in ((None, "bf16"), ("w8a8", "int8")):
            int8_cuda.reset_launches()
            mean = run_inference(ckpt, [recording], os.path.join(root, f"out_{rung}"),
                                 FLAGSHIP_DATA, engine=False, precision=cli, device=dev)
            n = int(mean["n_windows"])
            k1 = int8_cuda.int8_conv.launches
            rel = abs(mean["esr_psnr"] - want_psnr[rung]) / abs(want_psnr[rung])
            print(f"infer (run_inference) with --precision {cli} over a bf16 checkpoint: ran "
                  f"{rung}, {n} windows, mean ESR PSNR {mean['esr_psnr']:.5f} ({rel:.2e} from "
                  f"the harness's), int8_conv launches {k1}")
            if not rel <= 1e-5 or k1 != (79 * n if rung == "int8" else 0):
                fail(f"run_inference at {rung} disagrees with the harness or launched {k1}")
        int8_cuda.reset_launches()
        summary = serve.main(["--model_path", ckpt, "--output_path", os.path.join(root, "serve"),
                              "--loadgen", "2", "--precision", "int8", "--device", dev.type,
                              "--scale", "2", "--ori_scale", "down8", "--window", "1024",
                              "--sliding_window", "512", "--seql", "4", "--max_wall", "300"])
        k1 = int8_cuda.int8_conv.launches
        print(f"serve --precision int8: {summary['completed']} of {summary['requests']} "
              f"streams done, {summary['windows']} windows, int8_conv launches {k1}")
        if summary["completed"] != 2 or not k1 > 0:
            fail("serve --precision int8 did not serve its streams through the int8 kernels")
    finally:
        logging.getLogger().setLevel(level)
        shutil.rmtree(root, ignore_errors=True)


def phase_precision(torch, np, dev, card):
    """The precision rungs at the flagship width: K1 and K2 against their
    plain versions at every seam shape; the harness over the slice's
    windows at f32, bf16 and int8 (per-window PSNR and SSIM, the drop
    against f32 held to 1.0 dB); the engine and serving at each rung."""
    from esr_tpu_torch.data.synthetic import make_synthetic_recording
    from esr_tpu_torch.inference.engine import StreamingEngine
    from esr_tpu_torch.inference.harness import InferenceRunner
    from esr_tpu_torch.ops import dcn_cuda, int8_cuda
    from esr_tpu_torch.serving.server import ServingEngine

    model = flagship_model(torch, np, dcn_sparse=False).to(dev).eval()
    recording = make_synthetic_recording((720, 1280), base_events=80_000, num_frames=2,
                                         rungs=("down8", "down16"), seed=0)
    kh, kw = 90, 160
    shapes = int8_kernel_shapes(torch, np, dev, card, model, kh, kw)
    seams = len(int8_seam_calls(torch, model, dev, 1, kh, kw))

    # the harness over the slice's windows at each rung
    per = {}
    k_launches = {}
    window_device = {}
    for rung in RUNGS:
        runner = InferenceRunner(model, 3, device=dev, precision=rung)
        rung_window_metrics(torch, runner, recording, dev)  # warm
        dcn_cuda.reset_launches()
        int8_cuda.reset_launches()
        per[rung] = rung_window_metrics(torch, runner, recording, dev)
        n = len(per[rung][0])
        counts = counts_of()
        k_launches[rung] = {k.name: k.launches for k in int8_cuda.KERNELS}
        window_device[rung] = rung_window_profile(torch, runner, recording, dev, card)
        want8 = seams * n if rung == "int8" else 0
        print(f"harness {rung}: {n} windows; launches {counts}, {k_launches[rung]}")
        if counts != only("dcn_fwd", 2 * n) or any(c != want8
                                                    for c in k_launches[rung].values()):
            fail(f"the {rung} harness launched {counts} / {k_launches[rung]}; expected "
                 f"dcn_fwd 2 and int8_conv / quantize_per_tensor {seams if want8 else 0} "
                 "a window")
    busy8, named8 = window_device["int8"]
    k1_ops = named8["int8_igemm_kernel"][1]
    k2_ops = sum(named8[k][1] for k in INT8_KERNEL_NAMES[1:])
    print(f"int8 window on {card}: {k1_ops} K1 and {k2_ops} K2 device operations for {seams} "
          f"seams ({(k1_ops + k2_ops) / seams:.3f} a seam); K1 "
          f"{named8['int8_igemm_kernel'][0]:.4f} ms, K2 "
          f"{sum(named8[k][0] for k in INT8_KERNEL_NAMES[1:]):.4f} ms of {busy8:.4f} ms device "
          f"busy; memsets {named8['Memset'][1]} (f32 window: "
          f"{window_device['f32'][1]['Memset'][1]})")
    if not k1_ops:
        fail("the int8 window's profile shows no int8_igemm_kernel")
    f32_psnr, f32_ssim, _, f32_preds = per["f32"]
    drops = {}
    for rung in RUNGS:
        psnr, ssim, lat, preds = per[rung]
        drop = float(np.mean(np.subtract(f32_psnr, psnr)))
        drops[rung] = drop
        out_err = max(float((p - f).abs().max()) / max(float(f.abs().max()), TINY)
                      for p, f in zip(preds, f32_preds))
        print(f"harness {rung} on {card}: per-window ESR PSNR {[round(v, 4) for v in psnr]}; "
              f"SSIM {[round(v, 5) for v in ssim]}; mean PSNR drop against f32 {drop:.5f} dB "
              f"(worst window {max(np.subtract(f32_psnr, psnr)):.5f}), mean SSIM drop "
              f"{float(np.mean(np.subtract(f32_ssim, ssim))):.6f}; prediction max |rung - f32| "
              f"/ max |f32| {out_err:.3e}; window latency p50 "
              f"{sorted(lat)[len(lat) // 2]:.3f} ms")
        if rung != "f32" and not drop <= PSNR_DROP_DB:
            fail(f"the {rung} rung drops {drop:.3f} dB of PSNR against f32 "
                 f"(bound {PSNR_DROP_DB})")

    rung_entry_points(torch, np, dev, model, recording,
                      {r: float(np.mean(per[r][0])) for r in ("bf16", "int8")})

    # the engine at each rung (sparse flagship, lanes 4 x chunk 8)
    sparse = flagship_model(torch, np, dcn_sparse=True)
    recs = [make_synthetic_recording((720, 1280), base_events=ev, num_frames=2,
                                     rungs=("down8", "down16"), seed=30 + i,
                                     name=f"engine{i}")
            for i, ev in enumerate((120_000, 200_000, 80_000, 160_000, 100_000, 140_000))]
    engine_out = {}
    for rung in RUNGS:
        engine = StreamingEngine(sparse, 3, lanes=LANES, chunk_windows=CHUNK_WINDOWS,
                                 precision=rung, device=dev)
        engine.run_datalist(recs[:1], FLAGSHIP_DATA)  # warm
        torch.cuda.synchronize()
        dcn_cuda.reset_launches()
        int8_cuda.reset_launches()
        t0 = time.perf_counter()
        results, _ = engine.run_datalist(recs, FLAGSHIP_DATA)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = CHUNK_WINDOWS * len(engine.chunk_seconds)
        n_windows = int(sum(r["n_windows"] for r in results))
        launches = {k.name: k.launches for k in int8_cuda.KERNELS}
        want8 = seams * steps if rung == "int8" else 0
        if counts_of() != only("dcn_fwd_masked", 2 * steps) or any(
                c != want8 for c in launches.values()):
            fail(f"the {rung} engine launched {counts_of()} / {launches}")
        engine_out[rung] = (results, n_windows / wall, launches)
        chunk_ms = sorted(t * 1e3 for t in engine.chunk_seconds)
        print(f"engine {rung} on {card}: {n_windows} windows in {wall:.3f} s, "
              f"{n_windows / wall:.3f} windows/s; chunk p50 {chunk_ms[len(chunk_ms) // 2]:.3f} "
              f"ms; launches {launches}")
    for rung in ("bf16", "int8"):
        worst = max(f["esr_psnr"] - r["esr_psnr"]
                    for f, r in zip(engine_out["f32"][0], engine_out[rung][0]))
        print(f"engine {rung}: worst recording's ESR PSNR drop against f32 {worst:.5f} dB")
        if not worst <= PSNR_DROP_DB:
            fail(f"the {rung} engine drops {worst:.3f} dB of PSNR against f32")

    # serving at each rung: the serving phase's traffic
    classes, streams, schedule = serving_traffic()
    serve_out = {}
    for rung in RUNGS:
        def server(**kw):
            return ServingEngine(sparse, SERVE_DATA, lanes=LANES, classes=classes,
                                 default_class="standard", precision=rung,
                                 activity_tile=SERVE_ACTIVITY_TILE, device=dev, **kw)

        server(preempt_quantum=0).run(schedule[:1])  # warm
        srv = server(preempt_quantum=2)
        summary = srv.run(schedule, max_wall_s=600)
        torch.cuda.synchronize()
        if summary["completed"] != len(streams) or any(
                r["status"] != "ok" for r in srv.reports().values()):
            fail(f"serving at {rung}: not every request ended done")
        serve_out[rung] = (summary, srv.reports())
        p50 = {n: c["p50_window_ms"] for n, c in summary["classes"].items()}
        print(f"serving {rung} on {card}: {summary['windows_per_sec']} windows/s computed, "
              f"{summary['served_windows_per_sec']} served, {summary['preemptions']} "
              f"preemptions, window p50 by class {p50} ms")
    for rung in ("bf16", "int8"):
        ref = serve_out["f32"][1]
        worst = max(ref[rid]["esr_psnr"] - r["esr_psnr"]
                    for rid, r in serve_out[rung][1].items() if r["n_windows"])
        print(f"serving {rung}: worst request's ESR PSNR drop against f32 {worst:.5f} dB")
        if not worst <= PSNR_DROP_DB:
            fail(f"serving at {rung} drops {worst:.3f} dB of PSNR against f32")
    return {"shapes": shapes, "harness_launches": k_launches["int8"], "seams": seams,
            "window_device": window_device,
            "drops": drops, "engine_launches": engine_out["int8"][2],
            "windows_per_s": {r: engine_out[r][1] for r in RUNGS}}

def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "esr_tpu_torch" / "csrc" / "dcn_train.cu").is_file():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    import numpy as np

    from esr_tpu_torch.device import resolve_device
    from esr_tpu_torch.ops import dcn_cuda

    # -- 1. device ---------------------------------------------------------
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card)
    print(f"device: {kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    from esr_tpu_torch.ops import int8_cuda

    libraries = dcn_cuda.LIBRARIES + int8_cuda.LIBRARIES
    t0 = time.perf_counter()
    for lib in libraries:
        lib.start_build()
    for lib in libraries:
        lib.load()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(libraries)} "
          "libraries, nvcc runs started together")
    spills = []
    for lib in libraries:
        print(f"build {lib.source.name}: nvcc {lib.build_seconds} s -> {lib.library_path.name}")
        entry = ""
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas: {line.strip()}")
            if "spill" in line and not line.strip().endswith(
                    "0 bytes spill stores, 0 bytes spill loads"):
                spills.append(entry)
    if spills:
        fail(f"ptxas spilled registers in {spills}")
    from esr_tpu_torch import native

    t0 = time.perf_counter()
    if native.LIBRARY.load() is None:
        fail(f"the native host kernels did not build:\n{native.LIBRARY.build_log}")
    print(f"build host_kernels.cpp: g++ {time.perf_counter() - t0:.2f} s")

    marks = [time.perf_counter()]

    def done(phase: str) -> None:
        marks.append(time.perf_counter())
        print(f"chip_smoke: {phase} done at {marks[-1] - t_start:.1f} s, "
              f"{marks[-1] - marks[-2]:.1f} s in it")

    # -- 3.-5. kernels -----------------------------------------------------
    fwd, fwd_worst = phase_fwd_kernel(torch, np, card)
    done("the forward kernel phase")
    train_kernels, train_worst = phase_train_kernels(torch, np, card)
    done("the train kernel phase")
    phase_autograd(torch, np)
    masked, masked_worst = phase_masked_kernels(torch, np, card)
    done("the masked kernel phase")

    # -- 6. inference slice ------------------------------------------------
    fwd_launches = phase_slice(torch, np, dev, card)

    # -- 7. the streaming engine and serving (sparse flagship) -------------
    engine_launches, engine_stats = phase_engine(torch, np, dev, card)
    done("the slice and engine phases")
    serve_root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    # the SR recipe's artifacts, exported in phase 10c and served in 8e
    sr_aot_root = tempfile.mkdtemp(prefix="chip_smoke_sr_aot_")
    atexit.register(shutil.rmtree, sr_aot_root, True)
    try:
        serve_launches, serve_summary = phase_serving(torch, np, dev, card, repo, serve_root)
        done("the serving phase")
        # -- 10b. the serving fleet (3 replicas, the fleet view, faults) ----
        fleet_launches, _ = phase_fleet(torch, np, dev, card, repo,
                                        os.path.join(serve_root, "fleet"))
        done("the fleet phase")
        # -- 10c. the AOT export, served -----------------------------------
        sr_artifacts = phase_aot(torch, np, dev, card, repo, os.path.join(serve_root, "aot"),
                                 sr_aot_root)
        done("the AOT phase")
    finally:
        shutil.rmtree(serve_root, ignore_errors=True)

    # -- 12. the precision rungs (bf16, int8) -----------------------------
    precision = phase_precision(torch, np, dev, card)
    done("the precision phase")

    # -- 8. training, and the sparse train step ----------------------------
    out_root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        totals, sparse_launches, recs = phase_train(torch, np, dev, card, repo, out_root)
        done("the train phase")
        # -- 8c. the flagship's groups, validation and the engine's chunk as
        # CUDA graphs ------------------------------------------------------
        graph_launches = phase_graphs(torch, np, dev, card, repo,
                                      os.path.join(out_root, "graphs"))
        done("the graphs phase")
        # -- 8d. the second shipped recipe (SRUNetRecurrentSeq) -------------
        sr_ckpt, sr_evals, c10 = phase_srunet(torch, np, dev, card, repo,
                                              os.path.join(out_root, "srunet"), recs)
        done("the SRUNet phase")
        # -- 8e. the SR recipe at serving, the fleet, AOT and the rungs -----
        srunet = phase_srunet_serving(torch, np, dev, card, repo,
                                      os.path.join(out_root, "srunet_serving"), sr_ckpt,
                                      sr_evals, sr_artifacts)
        done("the SRUNet serving phase")
        # -- 8f. the data options, LPIPS, and C10's window again -------------
        phase_data_options(torch, np, dev, card, repo, os.path.join(out_root, "options"),
                           graph_launches.pop("recordings"), c10)
        done("the data options and LPIPS phase")
        # -- 7c. the 4x recipe --------------------------------------------
        totals_4x = phase_train_4x(torch, np, dev, card, repo, os.path.join(out_root, "x4"),
                                   fwd["valid_4x_b8"], train_kernels["train_4x_b8"])
        done("the 4x phase")
        # -- 8b. the trainer's runtime, and the chaos scenario ------------
        phase_train_runtime(torch, np, dev, card, repo, os.path.join(out_root, "runtime"), recs)
        done("the train runtime phase")
    finally:
        shutil.rmtree(out_root, ignore_errors=True)

    b1 = fwd["flagship_b1"]
    records = [{
        "name": "dcn_fwd", "route": "cuda", "source": "esr_tpu_torch/csrc/dcn_fwd.cu",
        "replaces": REPLACES["dcn_fwd"], "launches": fwd_launches,
        "max_abs_err": b1["err"], "ms": b1["ms"], "entry_ms": b1["entry_ms"],
        "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"], "library_ms": None,
        "matrix_max_rel_err": fwd_worst, "b4": fwd["flagship_b4"],
        "validation_b8": fwd["flagship_b8"], "b32": fwd["flagship_b32"],
        "train_run_launches": totals["dcn_fwd"], "validation_4x_b8": fwd["valid_4x_b8"],
        "train_4x_run_launches": totals_4x["dcn_fwd"],
    }]
    for name in ("dcn_train_fwd", "dcn_bwd", "dcn_wgrad"):
        r = train_kernels["train_flagship_b32"][name]
        records.append({
            "name": name, "route": "cuda", "source": "esr_tpu_torch/csrc/dcn_train.cu",
            "replaces": REPLACES[name], "launches": totals[name],
            "max_abs_err": r["err"], "ms": r["ms"], "entry_ms": r["entry_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "matrix_max_rel_err": train_worst[name], "shape": "B=32 flagship training",
            "train_4x_run_launches": totals_4x[name],
            "graphs_k8_run_launches": graph_launches["k8"][name],
            "captured_group_launches": graph_launches["graph"][name],
            "by_shape": {case: train_kernels[case][name] for case in TIMED_TRAIN_CASES[1:]},
        })
    for name, source, b, launches, extra in (
            ("dcn_fwd_masked", "esr_tpu_torch/csrc/dcn_fwd.cu", "b4", engine_launches,
             {"serving_launches": serve_launches, "fleet_launches": fleet_launches,
              "shape": "B=4 lanes, 100% active"}),
            ("dcn_train_fwd_masked", "esr_tpu_torch/csrc/dcn_train.cu", "b32",
             sparse_launches, {"shape": "B=32 flagship training, 100% active"})):
        r = masked[name][b]
        full = r["active100"]
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": r["err"], "ms": full["ms"],
            "entry_ms": full["entry_ms"],
            "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
            "bound_by": full["bound_by"], "library_ms": None,
            "matrix_max_rel_err": masked_worst[name], **extra,
            "by_batch_and_active_share": masked[name],
        })
    # K1 and K2 at the B=1 window's costliest seam shape; every shape beside
    b1 = [r for r in precision["shapes"] if r["batch"] == 1]
    top = max(b1, key=lambda r: r["ms"] * r["calls_per_window"])
    shape = f"{top['shape']} -> {top['cout']}, k {top['k']}, stride {top['stride']}"
    records.append({
        "name": "int8_conv", "route": "cuda", "source": "esr_tpu_torch/csrc/int8_conv.cu",
        "replaces": REPLACES["int8_conv"],
        "launches": precision["harness_launches"]["int8_conv"], "max_abs_err": 0.0,
        "ms": top["ms"], "entry_ms": top["entry_ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": top["library_ms"],
        "library": "torch._int_mm over an im2col (the GEMM alone)", "shape": shape,
        "device_ms_per_window": precision["window_device"]["int8"][1]["int8_igemm_kernel"][0],
        "graph_ms": top["graph_ms"], "launch_floor_ms": top["launch_floor_ms"],
        "plan": top["plan"],
        "engine_launches": precision["engine_launches"]["int8_conv"],
        "seams_per_window": precision["seams"], "by_shape": precision["shapes"],
        "srunet_seams_per_window": SR_SEAM_CALLS, "srunet_by_shape": srunet["shapes"],
    })
    records.append({
        "name": "quantize_per_tensor", "route": "cuda",
        "source": "esr_tpu_torch/csrc/int8_conv.cu",
        "replaces": REPLACES["quantize_per_tensor"],
        "launches": precision["harness_launches"]["quantize_per_tensor"],
        "max_abs_err": 0.0, "ms": top["k2_ms"], "entry_ms": top["k2_entry_ms"],
        "plain_ms": top["k2_plain_ms"],
        "device_ms_per_window": sum(precision["window_device"]["int8"][1][k][0]
                                    for k in INT8_KERNEL_NAMES[1:]),
        "graph_ms": top["k2_graph_ms"], "launch_floor_ms": top["launch_floor_ms"],
        "bound_ms": top["k2_bound_ms"], "bound_by": "bytes", "library_ms": None,
        "shape": str(top["shape"]),
        "engine_launches": precision["engine_launches"]["quantize_per_tensor"],
        "large_shapes": srunet["k2_large"],
    })
    for r in records:
        # the torch.library op the wrapper calls (``ms`` is through it)
        r["op"] = f"esr_tpu_torch::{r['name']}"
    print(f"chip_smoke: every phase green in {time.perf_counter() - t_start:.1f} s on {card}, "
          "the kernels' builds included")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
