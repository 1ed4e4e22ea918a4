"""Inference entry point of the port:

    python -m esr_tpu_torch.infer --model_path <ckpt-dir> --data_list test.txt \\
        --output_path out/ --scale 2 --ori_scale down16 --no_engine [--device cuda]

The checkpoint is a directory with ``params.npz`` and ``config.json``
(``esr_tpu_torch.inference.checkpoint``). It runs on the CUDA card by
default; ``--device cpu`` runs it on the CPU. ``--engine`` (or, without
``--engine``/``--no_engine``, the checkpoint's ``inference.engine``, which
the flagship config sets) streams the datalist through the batched
streaming engine at ``--lanes`` x ``--chunk_windows`` (default: the
checkpoint's ``inference`` block, else 4 x 8); ``--no_engine`` runs the
sequential harness. ``--save_images`` writes each window's PNG views in the
reference's layout (sequential harness only; the engine warns and ignores
it). LPIPS and the bf16/int8 rungs are not ported yet and raise when asked
for, by a flag or by the checkpoint's config.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Optional, Sequence


def get_flags(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="ESR inference (PyTorch/CUDA port)")
    p.add_argument("--model_path", type=str, required=True, help="checkpoint dir")
    p.add_argument("--data_path", type=str, default=None, help="single recording")
    p.add_argument("--data_list", type=str, default=None, help="datalist txt")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--save_images", dest="save_images", action="store_true", default=False,
                   help="PNG views of every window (sequential harness only)")
    p.add_argument("--no_save_images", dest="save_images", action="store_false")
    p.add_argument("--lpips_backbone", type=str, default=None,
                   help="LPIPS (not ported yet: raises)")
    p.add_argument("--lpips_net", type=str, default="alex",
                   choices=["alex", "vgg", "vgg16", "squeeze"])
    p.add_argument("--lpips_lins", type=str, default=None)
    p.add_argument("--allow_uncalibrated_lpips", action="store_true")
    p.add_argument("--engine", dest="engine", action="store_true", default=None,
                   help="batched streaming engine (default: the checkpoint's "
                        "inference.engine)")
    p.add_argument("--no_engine", dest="engine", action="store_false")
    p.add_argument("--lanes", type=int, default=None, help="engine mode only")
    p.add_argument("--chunk_windows", type=int, default=None, help="engine mode only")
    p.add_argument("--compile_cache", dest="compile_cache", action="store_true",
                   default=None, help="XLA cache of the reference; no effect here")
    p.add_argument("--no_compile_cache", dest="compile_cache", action="store_false")
    p.add_argument("--precision", type=str, default=None, choices=["f32", "bf16", "int8"],
                   help="compute precision (only f32 is ported)")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--seqn", type=int, default=3)
    p.add_argument("--seql", type=int, default=9)
    p.add_argument("--step_size", type=int, default=None)
    p.add_argument("--time_bins", type=int, default=1)
    p.add_argument("--ori_scale", type=str, default="down4")
    p.add_argument("--mode", type=str, default="events")
    p.add_argument("--window", type=int, default=2048)
    p.add_argument("--sliding_window", type=int, default=1024)
    p.add_argument("--need_gt_frame", dest="need_gt_frame", default=True, action="store_true")
    p.add_argument("--no_need_gt_frame", dest="need_gt_frame", action="store_false")
    p.add_argument("--need_gt_events", default=True, action="store_true")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    flags = get_flags(argv)
    if (flags.data_path is None) == (flags.data_list is None):
        raise SystemExit("pass exactly one of --data_path / --data_list")
    if flags.lpips_backbone is not None or flags.allow_uncalibrated_lpips:
        raise NotImplementedError("LPIPS is not ported yet")
    logging.basicConfig(level=logging.INFO)

    dataset_config = {
        "scale": flags.scale,
        "ori_scale": flags.ori_scale,
        "time_bins": flags.time_bins,
        "need_gt_frame": flags.need_gt_frame,
        "need_gt_events": flags.need_gt_events,
        "mode": flags.mode,
        "window": flags.window,
        "sliding_window": flags.sliding_window,
        "data_augment": {"enabled": False, "augment": [], "augment_prob": []},
        "sequence": {
            "sequence_length": flags.seql,
            "seqn": flags.seqn,
            "step_size": flags.step_size,
            "pause": {"enabled": False},
        },
    }
    from esr_tpu_torch.data.loader import read_datalist
    from esr_tpu_torch.inference.harness import run_inference

    data_list = (read_datalist(flags.data_list) if flags.data_list is not None
                 else [flags.data_path])
    mean = run_inference(
        flags.model_path, data_list, flags.output_path, dataset_config,
        save_images=flags.save_images, engine=flags.engine, precision=flags.precision, device=flags.device,
        lanes=flags.lanes, chunk_windows=flags.chunk_windows,
    )
    print(json.dumps({k: round(v, 6) for k, v in mean.items()}))
    return mean


if __name__ == "__main__":
    main()
