#!/usr/bin/env python3
"""Time the port's flagship train step and one evaluation window on the card,
for one checkout of the repository: the A/B yardstick of a change that
touches the whole step (such as the determinism of the train step).

    python scripts/time_port_step.py [--root DIR] [--tag NAME] [--free-algorithms]
        [--group K]

``--root`` is the checkout whose ``esr_tpu_torch`` is imported (default:
this one); run it once per checkout, in turns (parent, change, change,
parent), in one call on one card. The flagship ``DeepRecurrNet`` (basech 8,
seqn 3) gets seeded weights and a seeded batch of 32 sequences of L 9 at
90x160 (Poisson counts). It prints one JSON line: the card and its power
limit, the train step (BPTT, backward, Adam-amsgrad) as the median of 5
after 2 warm ones (host clock to ``synchronize``), its device-busy time
and top kernels under ``torch.profiler``, the same for one batch-1 window
under ``no_grad``, and ``dcn_bwd``'s time through its wrapper at the
flagship B=32. ``--free-algorithms`` turns ``torch.use_deterministic_algorithms``
off after the device is resolved, to split a change's cost between the
library's deterministic algorithms and the rest.

``--group K`` times a full group of ``K`` train steps (the flagship's
``k_steps`` is 8) as the checkout's trainer runs it: through its
``training.multistep`` super-step where it has one (on the card one CUDA
graph replay, the batches copied into the static slots first), and as ``K``
eager steps in the same process, in turns (eager, group, group, eager,
twice, then eager and group: five each). The steps are the checkout's own ``make_train_step`` and
``make_optimizer`` (Adam, amsgrad, weight decay 1e-4, as the flagship's) on
``K`` seeded batches. A checkout with no ``training.multistep`` (before the
super-step was ported) runs its groups step by step, so there the group is
the eager loop. It adds to the JSON line each way's group ms (the five
runs and their median), a step's ms, windows/s, each way's device busy and
idle share under ``torch.profiler`` and the peak memory above the state.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def device_busy(torch, prof):
    """(device-busy ms, [(kernel, ms)] top 5) of a profile: device-side
    entries only (a CPU op's own device time repeats its kernels)."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == cuda and dev_us(e) > 0), key=dev_us, reverse=True)
    return (sum(dev_us(e) for e in events) / 1e3,
            [(e.key[:60], round(dev_us(e) / 1e3, 3), e.count) for e in events[:6]])


def time_group(torch, model, rng, dev, k: int) -> dict:
    """A full group of ``k`` steps, eagerly and as the checkout's super-step
    (module docstring)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from esr_tpu_torch.training.optim import make_optimizer
    from esr_tpu_torch.training.train_step import make_train_step

    try:
        from esr_tpu_torch.training.multistep import make_multi_step
    except ImportError:  # a checkout from before the super-step
        make_multi_step = None
    model.train()
    opt = make_optimizer("Adam", model.parameters(), lr=1e-4, weight_decay=1e-4,
                         amsgrad=True)
    step = make_train_step(model, opt, 3)
    batches = [{k_: torch.from_numpy(rng.poisson(0.3, (32, 9, 90, 160, 2)).astype(np.float32))
                .to(dev) for k_ in ("inp", "gt")} for _ in range(k)]

    def eager():
        for b in batches:
            step(b)

    fused = eager
    if make_multi_step is not None:
        multi = make_multi_step(step, k, optimizer=opt)

        def fused():
            for j, b in enumerate(batches):
                multi.load(j, b)
            multi()

    eager()
    fused()
    fused()  # the warm-up, then the capture
    times = {"eager": [], "group": []}
    for way in ("eager", "group", "group", "eager") * 2 + ("eager", "group"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (eager if way == "eager" else fused)()
        torch.cuda.synchronize()
        times[way].append((time.perf_counter() - t0) * 1e3)
    out = {"k": k, "super_step": make_multi_step is not None}
    for way, fn in (("eager", eager), ("group", fused)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, _ = device_busy(torch, prof)
        ts = sorted(times[way])
        out[way] = {"ms": [round(t, 3) for t in times[way]], "ms_median": round(ts[2], 3),
                    "step_ms": round(ts[2] / k, 3),
                    "windows_per_sec": round(k * 32 * 7 / (ts[2] / 1e3), 1),
                    "device_busy_ms": round(busy, 3), "profiled_ms": round(wall, 3),
                    "idle_share": round(1 - busy / wall, 4),
                    "peak_gib_above_state": round(peak, 4)}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    p.add_argument("--tag", default="")
    p.add_argument("--free-algorithms", action="store_true")
    p.add_argument("--group", type=int, default=0)
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from esr_tpu_torch.device import resolve_device
    from esr_tpu_torch.models.esr import DeepRecurrNet
    from esr_tpu_torch.ops import dcn_cuda
    from esr_tpu_torch.training.train_step import window_losses

    if not torch.cuda.is_available():
        print("time_port_step: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    if args.free_algorithms:
        torch.use_deterministic_algorithms(False)
    dcn_cuda.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    model = DeepRecurrNet(inch=2, basech=8, num_frame=3).to(dev)
    with torch.no_grad():
        om = model.spacetime_fuse.dcn_offset_mask
        om.weight.copy_(torch.from_numpy(
            (rng.standard_normal(tuple(om.weight.shape)) * 0.05).astype(np.float32)))
        om.bias.copy_(torch.from_numpy(rng.standard_normal(tuple(om.bias.shape))
                                       .astype(np.float32)))
    batch = {k: torch.from_numpy(rng.poisson(0.3, (32, 9, 90, 160, 2)).astype(np.float32))
             .to(dev) for k in ("inp", "gt")}
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, amsgrad=True, weight_decay=1e-4)

    def step():
        opt.zero_grad()
        losses, _ = window_losses(model, batch, 3)
        losses.sum().backward()
        opt.step()

    times = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    step_busy, step_top = device_busy(torch, prof)

    model.eval()
    inp = batch["inp"][:1, :3]
    states = model.init_states(1, 90, 160, device=dev)
    win = []
    with torch.no_grad():
        for i in range(25):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(inp, states)
            torch.cuda.synchronize()
            if i >= 5:
                win.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(inp, states)
            torch.cuda.synchronize()
    win_busy, _ = device_busy(torch, prof)

    x = torch.randn(32, 12, 20, 64, device=dev)
    off = torch.randn(32, 12, 20, 8, 9, 2, device=dev) * 2
    mask = torch.rand(32, 12, 20, 8, 9, device=dev)
    w = torch.randn(3, 3, 64, 64, device=dev) * 0.04
    g = torch.randn(32, 12, 20, 64, device=dev)
    for _ in range(10):
        dcn_cuda.dcn_bwd(x, off, mask, w, g)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        dcn_cuda.dcn_bwd(x, off, mask, w, g)
    end.record()
    torch.cuda.synchronize()

    group = time_group(torch, model, rng, dev, args.group) if args.group else None

    times.sort()
    win.sort()
    print(json.dumps({
        "group": group,
        "tag": args.tag, "root": args.root, "card": card,
        "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
        "step_ms_median": round(times[len(times) // 2], 3),
        "step_ms": [round(t, 3) for t in times],
        "step_device_busy_ms": round(step_busy, 3), "step_top_kernels": step_top,
        "window_ms_p50": round(win[len(win) // 2], 3),
        "window_device_busy_ms": round(win_busy, 3),
        "dcn_bwd_wrapper_ms_b32": round(start.elapsed_time(end) / 200, 5),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
