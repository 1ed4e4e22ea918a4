"""Serving entry point of the port: one replica serving a stream corpus.

    python -m esr_tpu_torch.serve --model_path <ckpt-dir> --output_path out/ \\
        (--data_list streams.txt | --loadgen N) [--rate 4] [--seed 0] \\
        [--lanes 4] [--classes interactive:2,standard:8,bulk:16] \\
        [--default_class standard] [--max_pending 64] [--preempt_quantum 4] \\
        [--max_wall S] [--device cuda|cpu] [dataset flags as infer.py]

Arrivals come on a seeded Poisson schedule at ``--rate`` streams/s, with the
classes dealt round robin; ``--loadgen N`` serves N seeded synthetic
in-memory streams instead of a datalist. ``--classes`` takes
``name:chunk_windows[:min_activity]`` entries; a class with
``min_activity > 0`` skips windows whose active-tile fraction is below it.
It writes ``serve_requests.jsonl`` (one report per request) and
``serve_summary.json`` under ``--output_path`` and prints the summary. It
runs on the card unless ``--device cpu`` is given. ``--precision`` picks
the rung (f32, bf16 or int8, or an alias); omitted, the checkpoint's
``trainer.precision``, else f32. ``--replicas > 1``, ``--aot``,
``--live-port`` and ``--profile-steps`` are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, Optional, Sequence

from esr_tpu_torch.config.precision import PRECISION_SPELLINGS, resolve_precision


def get_flags(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="ESR serving (PyTorch/CUDA port)")
    p.add_argument("--model_path", type=str, required=True, help="checkpoint dir")
    p.add_argument("--data_list", type=str, default=None, help="datalist of streams")
    p.add_argument("--loadgen", type=int, default=None,
                   help="serve N seeded synthetic streams instead of a datalist")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--rate", type=float, default=4.0, help="Poisson arrivals per second")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lanes", type=int, default=4)
    p.add_argument("--classes", type=str, default="interactive:2,standard:8,bulk:16",
                   help="name:chunk_windows[:min_activity][,...]")
    p.add_argument("--default_class", type=str, default="standard")
    p.add_argument("--max_pending", type=int, default=64)
    p.add_argument("--preempt_quantum", type=int, default=4, help="0 disables preemption")
    p.add_argument("--max_wall", type=float, default=None, help="bound on the loop, seconds")
    p.add_argument("--lane_quarantine_k", type=int, default=3)
    p.add_argument("--request_retries", type=int, default=1)
    p.add_argument("--replicas", type=int, default=1, help="only 1 is ported")
    p.add_argument("--aot", action="store_true", default=False, help="not ported: raises")
    p.add_argument("--live-port", dest="live_port", type=int, default=None,
                   help="not ported: raises")
    p.add_argument("--profile-steps", dest="profile_steps", type=int, default=0,
                   help="not ported: raises")
    p.add_argument("--precision", type=str, default=None, choices=PRECISION_SPELLINGS,
                   help="compute precision: f32, bf16 or int8, or an alias (default: "
                        "the checkpoint's trainer.precision, else f32; int8 = "
                        "post-training quantization at the contraction seams)")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--seqn", type=int, default=3)
    p.add_argument("--seql", type=int, default=9)
    p.add_argument("--step_size", type=int, default=None)
    p.add_argument("--time_bins", type=int, default=1)
    p.add_argument("--ori_scale", type=str, default="down4")
    p.add_argument("--mode", type=str, default="events")
    p.add_argument("--window", type=int, default=2048)
    p.add_argument("--sliding_window", type=int, default=1024)
    return p.parse_args(argv)


def parse_classes(spec: str) -> Dict:
    """``name:chunk_windows[:min_activity][,...]`` -> request classes."""
    from esr_tpu_torch.serving.scheduler import RequestClass

    out = {}
    for part in spec.split(","):
        name, _, rest = part.strip().partition(":")
        w, _, min_act = rest.partition(":")
        if not name or not w:
            raise ValueError(f"bad --classes entry {part!r} "
                             "(want name:chunk_windows[:min_activity])")
        out[name] = RequestClass(name, chunk_windows=int(w),
                                 min_activity=float(min_act) if min_act else 0.0)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    flags = get_flags(argv)
    if (flags.data_list is None) == (flags.loadgen is None):
        raise SystemExit("pass exactly one of --data_list / --loadgen")
    if flags.replicas > 1:
        raise NotImplementedError("the serving fleet (--replicas > 1) is not ported yet")
    if flags.aot:
        raise NotImplementedError("AOT chunk programs (--aot) are not ported yet")
    logging.basicConfig(level=logging.INFO)

    from esr_tpu_torch.inference.checkpoint import load_checkpoint
    from esr_tpu_torch.serving.loadgen import make_stream_corpus, poisson_schedule
    from esr_tpu_torch.serving.server import ServingEngine

    model, config = load_checkpoint(flags.model_path)
    precision = resolve_precision(
        cli=flags.precision, config=(config.get("trainer") or {}).get("precision"))
    classes = parse_classes(flags.classes)
    dataset_config = {
        "scale": flags.scale, "ori_scale": flags.ori_scale, "time_bins": flags.time_bins,
        "need_gt_frame": False, "need_gt_events": True, "mode": flags.mode,
        "window": flags.window, "sliding_window": flags.sliding_window,
        "data_augment": {"enabled": False, "augment": [], "augment_prob": []},
        "sequence": {"sequence_length": flags.seql, "seqn": flags.seqn,
                     "step_size": flags.step_size, "pause": {"enabled": False}},
    }
    server = ServingEngine(
        model, dataset_config, seqn=flags.seqn, lanes=flags.lanes, classes=classes,
        default_class=flags.default_class, max_pending=flags.max_pending,
        preempt_quantum=flags.preempt_quantum,
        lane_quarantine_k=flags.lane_quarantine_k,
        request_retries=flags.request_retries, live_port=flags.live_port,
        profile_steps=flags.profile_steps, precision=precision, device=flags.device,
    )
    if flags.loadgen is not None:
        streams = make_stream_corpus(n=flags.loadgen, seed=flags.seed)
    else:
        from esr_tpu_torch.data.loader import read_datalist

        streams = read_datalist(flags.data_list)
    schedule = poisson_schedule(streams, rate_hz=flags.rate, seed=flags.seed,
                                classes=tuple(sorted(classes)))
    summary = server.run(arrivals=schedule, max_wall_s=flags.max_wall)

    os.makedirs(flags.output_path, exist_ok=True)
    with open(os.path.join(flags.output_path, "serve_requests.jsonl"), "w") as f:
        for rid in sorted(server.reports()):
            f.write(json.dumps(server.report(rid)) + "\n")
    with open(os.path.join(flags.output_path, "serve_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
