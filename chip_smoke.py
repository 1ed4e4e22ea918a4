#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``esr_tpu_torch``) runs on the
card: builds the DCN kernel from ``esr_tpu_torch/csrc``, holds it against its
plain PyTorch version, and drives the sequential inference harness at the
flagship width.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``), the device
   count;
2. build: ``nvcc`` of the DCN kernel, its time and ``-Xptxas -v`` lines;
3. kernel: ``dcn_fwd`` against the plain ``deform_conv2d`` on the card at
   the flagship shape (B=1 and B=4) and over an odd-size / group / stride /
   dilation / large-offset matrix, within 1e-3 * max(|ref|, 1); CUDA-event
   times of both next to the roofline bound;
4. slice: ``InferenceRunner.run_recording`` at basech 8, seqn 3, scale 2,
   down16 -> down8 (90x160 HR grid), window 2048/1024, L 9, on a seeded
   720x1280 synthetic recording with seeded random weights brought in
   through the flax weight bridge (non-zero offset/mask conv). The DCN
   launch count must be exactly 2 per window, and every window's output
   and states must be finite and match the same model with
   ``dcn_impl='plain'`` within 1e-3 * max(|ref|, 1).

The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the f32
# rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
TOL = 1e-3  # scale-normalized, the reference's off-TPU f32 DCN bound


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


def bound(inp: dict, out_numel: int):
    """Least time for the same work: every input read once and the output
    written once, vs the contraction's f32 FLOPs."""
    tensors = [v for v in inp.values() if v is not None]
    nbytes = 4 * (sum(t.numel() for t in tensors) + out_numel)
    b, ho, wo, _, k, _ = inp["offsets"].shape
    _, _, cin, cout = inp["weight"].shape
    flops = 2.0 * b * ho * wo * k * cin * cout
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def profile_windows(torch, model, loader, dev, card, n: int = 3) -> None:
    """Where one window's time goes: device busy time by kernel over ``n``
    forwards (``torch.profiler``), against the host wall clock."""
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

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    # device-side entries only (kernels, copies): a CPU op's own device time
    # repeats the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if e.device_type == cuda and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / len(batches)
    if not events:
        print("profile: device time not measured (the profiler saw no device events)")
        return
    print(f"profile on {card}: {len(batches)} windows, wall {wall_ms:.3f} ms/window, "
          f"device busy {busy_ms:.3f} ms/window, idle share {1 - busy_ms / wall_ms:.3f}")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"profile kernel: {dev_us(e) / 1e3 / len(batches):.4f} ms/window, "
              f"{e.count // len(batches)} calls/window: {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "esr_tpu_torch" / "csrc" / "dcn_fwd.cu").is_file():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    import numpy as np

    from esr_tpu_torch.device import resolve_device
    from esr_tpu_torch.ops.dcn import deform_conv2d
    from esr_tpu_torch.ops.dcn_cuda import dcn_fwd

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
    t0 = time.perf_counter()
    dcn_fwd.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {dcn_fwd.build_seconds} s) "
          f"-> {dcn_fwd.library_path.name}")
    for line in dcn_fwd.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    # -- 3. kernel phase ---------------------------------------------------
    rng = np.random.default_rng(0)
    flagship = {}
    worst_rel = 0.0
    cases = [("flagship_b1", dict(b=1, h=12, w=20, cin=64, cout=64, dg=8), {}),
             ("flagship_b4", dict(b=4, h=12, w=20, cin=64, cout=64, dg=8), {})]
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
    for name, shape, geom in cases:
        inp = dcn_inputs(torch, rng, **shape)
        out = dcn_fwd(**inp, **geom)
        ref = deform_conv2d(**inp, **geom)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = max(float(ref.abs().max()), 1.0)
        finite = bool(torch.isfinite(out).all())
        print(f"kernel {name}: out {tuple(out.shape)} max_abs_err {err:.3e} "
              f"(limit {TOL * scale:.3e})")
        if not finite or not err <= TOL * scale:
            fail(f"dcn_fwd disagrees with the plain version on {name}")
        worst_rel = max(worst_rel, err / scale)
        if name.startswith("flagship"):
            ms = time_ms(torch, lambda: dcn_fwd(**inp, **geom), iters=500)
            plain_ms = time_ms(torch, lambda: deform_conv2d(**inp, **geom), iters=100)
            bound_ms, bound_by = bound(inp, out.numel())
            flagship[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
            print(f"time {name}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
                  f"bound {bound_ms:.6f} ms ({bound_by}) on {card}")

    # -- 4. slice phase ----------------------------------------------------
    from esr_tpu_torch.data.loader import InferenceSequenceLoader
    from esr_tpu_torch.data.synthetic import make_synthetic_recording
    from esr_tpu_torch.inference.harness import InferenceRunner
    from esr_tpu_torch.models import convert
    from esr_tpu_torch.models.esr import DeepRecurrNet

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

    dcn_fwd.launches = 0
    t0 = time.perf_counter()
    result = runner.run_recording(recording, dataset_config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dcn_fwd.launches
    n_windows = int(result["n_windows"])
    print(f"slice: {n_windows} windows in {wall:.3f} s, dcn_fwd launches {launches}")
    if n_windows < 8:
        fail(f"the recording gave {n_windows} windows, expected >= 8")
    if launches != 2 * n_windows:
        fail(f"dcn_fwd launched {launches} times for {n_windows} windows")
    if not all(math.isfinite(v) for v in result.values()):
        fail(f"non-finite metrics: {result}")
    print("slice metrics: " + json.dumps({k: result[k] for k in sorted(result)}))

    # every window again, kernel path and plain path side by side
    loader = InferenceSequenceLoader(recording, dataset_config)
    kh, kw = loader.gt_resolution
    states_k = model.init_states(1, kh, kw, device=dev)
    states_p = model.init_states(1, kh, kw, device=dev)
    worst_slice = 0.0
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
                err = float((a - r).abs().max())
                scale = max(float(r.abs().max()), 1.0)
                worst_slice = max(worst_slice, err / scale)
                if not err <= TOL * scale:
                    fail(f"window {i}: kernel path differs from plain by {err:.3e}")
            if tuple(out_k.shape) != (1, kh, kw, 2):
                fail(f"window {i}: output shape {tuple(out_k.shape)}")
    model.spacetime_fuse.dcn_impl = "auto"
    profile_windows(torch, model, loader, dev, card)
    lat_sorted = sorted(lat)
    print(f"slice vs plain: {len(lat)} windows, worst scale-normalized err "
          f"{worst_slice:.3e} (limit {TOL})")
    print(f"slice latency per window on {card}: mean harness {result['time'] * 1e3:.3f} ms; "
          f"replay p50 {lat_sorted[len(lat) // 2]:.3f} ms, max {lat_sorted[-1]:.3f} ms")

    b1, b4 = flagship["flagship_b1"], flagship["flagship_b4"]
    record = {
        "name": "dcn_fwd",
        "route": "cuda",
        "source": "esr_tpu_torch/csrc/dcn_fwd.cu",
        "replaces": "esr_tpu/ops/dcn_pallas.py:326",
        "launches": launches,
        "max_abs_err": b1["err"],
        "ms": b1["ms"],
        "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"],
        "bound_by": b1["bound_by"],
        "library_ms": None,
        "err": b1["err"],
        "kernel_ms": b1["ms"],
        "matrix_max_rel_err": worst_rel,
        "b4": b4,
    }
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
