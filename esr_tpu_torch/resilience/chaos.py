"""The scripted chaos scenario: train -> restore -> serve under faults
(counterpart of ``esr_tpu/resilience/chaos.py``, with the same corpus, the
same fault plans from the seed and the same checks).

1. **twin train**: a fault-free run of the trainer on a synthetic corpus.
2. **chaos train**: the same config and seed under a
   :class:`~esr_tpu_torch.resilience.faults.FaultPlan` over the prefetch
   (stall, corrupt batch), train-step (nan loss, dispatch error) and
   checkpoint-commit (a failing attempt) sites. The run must complete and
   rejoin the twin: the final checkpoint's parameters within ``1e-5``
   relative (the rollback replays the same batches, so they are equal)
   and the per-step loss series equal on every step both runs recorded.
3. **restore**: a validated restore with the newest commit's largest file
   truncated on disk (``ckpt_restore``/``truncate``); the previous commit
   must load.
4. **serve**: a serving session over the corpus with a lane fault
   (quarantine, request retry) and a preemption (drain, resume); every
   request must end with a classified status.

The corpus is the reference's (``write_synthetic_h5`` of the same sizes and
seeds), held in memory (``data.synthetic.make_synthetic_recording``). The
chaos run's ``telemetry.jsonl`` (the trainer's sink) and
``serve_telemetry.jsonl`` (phases 3-4) must each show
``faults.unrecovered == 0`` and pass ``configs/slo_chaos.yml``.

CLI: ``python -m esr_tpu_torch.resilience.chaos --out DIR [--seed N]
[--fast] [--basech C] [--device cpu]`` prints the summary and exits 0 iff
every check held. It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Dict, List, Optional, Sequence

from esr_tpu_torch.resilience.faults import FaultPlan, FaultSpec, installed

# the reference's scenario scale: one epoch covers the run, so the fault
# ordinals map 1:1 onto iterations
ITERATIONS = 10
SAVE_PERIOD = 4
BATCH_SIZE = 8
CORRUPT_ITER = 5          # after the first committed save
STALL_ITEM = 1
COMMIT_FAIL_ITER = 2 * SAVE_PERIOD
STALL_S = 2.5
STALL_TIMEOUT_S = 1.0


def build_corpus(n_rec: int = 4, num_frames: int = 12, resolution=(64, 64)) -> List:
    """The reference's synthetic recordings (``write_synthetic_h5`` with
    ``base_events=2048`` and seeds ``0..n_rec-1``), in memory."""
    from esr_tpu_torch.data.synthetic import make_synthetic_recording

    return [make_synthetic_recording(resolution, base_events=2048, num_frames=num_frames,
                                     seed=i, name=f"rec{i}") for i in range(n_rec)]


def dataset_config() -> Dict:
    return {
        "scale": 2,
        "ori_scale": "down4",
        "time_bins": 1,
        "mode": "events",
        "window": 128,
        "sliding_window": 64,
        "need_gt_events": True,
        "need_gt_frame": False,
        "data_augment": {"enabled": False, "augment": [], "augment_prob": []},
        "sequence": {"sequence_length": 4, "seqn": 3, "step_size": 2,
                     "pause": {"enabled": False}},
    }


def train_config(out_root: str, basech: int = 4) -> Dict:
    """The reference's chaos config (its resilience knobs and the numerics
    plane on); the recordings come in memory, not from a datalist."""
    loader = {
        "path_to_datalist_txt": None,
        "batch_size": BATCH_SIZE,
        "shuffle": True,
        "drop_last": True,
        "prefetch": 0,
        "dataset": dataset_config(),
    }
    return {
        "experiment": "chaos",
        "model": {"name": "DeepRecurrNet", "args": {"inch": 2, "basech": basech, "num_frame": 3}},
        "optimizer": {"name": "Adam",
                      "args": {"lr": 1e-3, "weight_decay": 1e-4, "amsgrad": True}},
        "lr_scheduler": {"name": "ExponentialLR", "args": {"gamma": 0.95}},
        "trainer": {
            "output_path": out_root,
            "iteration_based_train": {
                "enabled": True,
                "iterations": ITERATIONS,
                "save_period": SAVE_PERIOD,
                "train_log_step": 4,
                "valid_step": 10**9,
                "lr_change_rate": 4000,
            },
            "monitor": "off",
            "tensorboard": False,
            "vis": {"enabled": False},
            "async_checkpoint": True,
            "k_steps": 1,
            "max_bad_steps": 1,
            "max_rollbacks": 2,
            "dispatch_retries": 1,
            "commit_retries": 2,
            "commit_backoff_s": 0.05,
            "prefetch_stall_timeout_s": STALL_TIMEOUT_S,
            # probes ride the gate: the corrupt batch's rollback must carry
            # a layer-named bad_tag, and the twin parity must hold with them
            "numerics": True,
        },
        "train_dataloader": loader,
        "valid_dataloader": None,
    }


def build_train_plan(seed: int) -> FaultPlan:
    """The train phase's 5 faults over 3 sites; the seed picks among the
    valid slots (the reference's draws)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nan_iter = int(rng.integers(2, SAVE_PERIOD))
    dispatch_iter = int(rng.integers(0, SAVE_PERIOD - 1))
    if dispatch_iter == nan_iter:
        dispatch_iter = nan_iter - 1
    return FaultPlan([
        FaultSpec("prefetch", STALL_ITEM, "stall", arg=STALL_S),
        FaultSpec("prefetch", CORRUPT_ITER, "corrupt"),
        FaultSpec("train_step", nan_iter, "nan_loss"),
        FaultSpec("train_step", dispatch_iter, "dispatch_error"),
        FaultSpec("ckpt_commit", COMMIT_FAIL_ITER, "fail"),
    ])


def build_serve_plan(seed: int) -> FaultPlan:
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    preempt_chunk = int(rng.integers(3, 5))
    return FaultPlan([
        FaultSpec("ckpt_restore", 0, "truncate"),
        FaultSpec("serve_chunk", 1, "lane_fault"),
        FaultSpec("serve_chunk", preempt_chunk, "preempt_signal"),
    ])


def _run_train(config: Dict, runid: str, seed: int, plan: Optional[FaultPlan],
               recordings: Sequence, device) -> Dict:
    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.training.trainer import Trainer

    run = RunConfig(copy.deepcopy(config), runid=runid, seed=seed)
    trainer = Trainer(run, device=device, train_recordings=recordings)
    if len(trainer.train_loader) < ITERATIONS:
        raise RuntimeError(f"corpus too small: {len(trainer.train_loader)} batches/epoch "
                           f"< {ITERATIONS} iterations (fault indices assume one epoch)")
    t0 = time.monotonic()
    if plan is not None:
        with installed(plan):
            result = trainer.train()
    else:
        result = trainer.train()
    wall = time.monotonic() - t0
    guard = trainer._guard
    return {
        "result": {k: round(v, 6) for k, v in result.items()},
        "wall_s": round(wall, 3),
        "save_dir": run.save_dir,
        "telemetry": os.path.join(run.log_dir, "telemetry.jsonl"),
        "rollbacks": guard.rollbacks if guard else 0,
        "skipped_iterations": sorted(set(guard.skipped_iterations)) if guard else [],
        "last_bad_tag": guard.last_bad_tag if guard else None,
    }


def _loss_series(telemetry_path: str) -> Dict[int, float]:
    """The last ``train_loss`` recorded per step (a replayed step
    overwrites its record from before the rollback)."""
    out: Dict[int, float] = {}
    with open(telemetry_path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if (rec.get("type") == "metric" and str(rec.get("name", "")).startswith("train_loss")
                    and rec.get("step") is not None):
                out[int(rec["step"])] = float(rec["value"])
    return out


def _params_diff(path_a: str, path_b: str):
    """``(max relative difference, bitwise equal)`` over two checkpoints'
    parameters."""
    import numpy as np

    from esr_tpu_torch.inference.checkpoint import read_params
    from esr_tpu_torch.models.convert import flatten_tree

    pa, pb = flatten_tree(read_params(path_a)), flatten_tree(read_params(path_b))
    if set(pa) != set(pb):
        raise ValueError("the two checkpoints hold different parameter trees")
    worst, bitwise = 0.0, True
    for k in pa:
        a, b = np.asarray(pa[k]), np.asarray(pb[k])
        bitwise = bitwise and a.tobytes() == b.tobytes()
        a, b = a.astype(np.float64), b.astype(np.float64)
        worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12))))
    return worst, bitwise


def _run_serve(ckpt_path: str, recordings: Sequence, plan: FaultPlan, device) -> Dict:
    from esr_tpu_torch.inference.checkpoint import load_checkpoint
    from esr_tpu_torch.serving.server import ServingEngine

    model, _ = load_checkpoint(ckpt_path)
    cfg = dataset_config()
    cfg["sequence"] = dict(cfg["sequence"], step_size=None)
    srv = ServingEngine(model, cfg, lanes=2, preempt_quantum=0, lane_quarantine_k=1,
                        request_retries=1, device=device)
    rids = [srv.submit(r) for r in recordings]
    with installed(plan):
        summary = srv.run(max_wall_s=120.0)
    return {"summary": summary, "reports": {rid: srv.report(rid) for rid in rids}}


def run_scenario(out_dir: str, seed: int = 0, fast: bool = False,
                 basech: Optional[int] = None, device=None) -> Dict:
    """The whole scenario; returns the summary with every check as a
    boolean. ``fast`` is the reference's tier-1 profile: the same corpus,
    plans and checks on a half-width model (``basech=2``; else 4).
    ``basech`` overrides both. Runs on the card unless ``device`` is the
    CPU."""
    from esr_tpu_torch.device import resolve_device
    from esr_tpu_torch.obs import TelemetrySink, set_active_sink
    from esr_tpu_torch.obs.report import report_file
    from esr_tpu_torch.resilience.recovery import restore_with_fallback

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    corpus = build_corpus()
    if basech is None:
        basech = 2 if fast else 4
    config = train_config(out_dir, basech=basech)

    twin = _run_train(config, "twin", seed, None, corpus, dev)
    chaos = _run_train(config, "chaos", seed, build_train_plan(seed), corpus, dev)
    final = f"checkpoint-iteration{ITERATIONS - 1}"
    params_diff, params_bitwise = _params_diff(os.path.join(twin["save_dir"], final),
                                               os.path.join(chaos["save_dir"], final))
    twin_losses = _loss_series(twin["telemetry"])
    chaos_losses = _loss_series(chaos["telemetry"])
    common = sorted(set(twin_losses) & set(chaos_losses))
    loss_diff = max((abs(twin_losses[s] - chaos_losses[s]) / max(abs(twin_losses[s]), 1e-12)
                     for s in common), default=0.0)

    # phases 3-4 under one sink: the validated restore, then serving
    serve_plan = build_serve_plan(seed)
    serve_tel = os.path.join(out_dir, "serve_telemetry.jsonl")
    sink = TelemetrySink(serve_tel)
    prev = set_active_sink(sink)
    t0 = time.monotonic()
    try:
        with installed(serve_plan):
            from esr_tpu_torch.config.build import build_model, build_optimizer

            model = build_model(config["model"]).to(dev)
            optimizer, _ = build_optimizer(config["optimizer"], model.parameters(),
                                           config.get("lr_scheduler"), None)
            start_iter, _, used_path = restore_with_fallback(chaos["save_dir"], model,
                                                             optimizer, config)
            restore = {
                "path_used": used_path,
                "start_iteration": start_iter,
                "fell_back": used_path is not None and not used_path.endswith(final),
            }
            if used_path is None:
                raise RuntimeError("no checkpoint of the chaos run restored")
            serve = _run_serve(used_path, corpus[:3], serve_plan, dev)
    finally:
        set_active_sink(prev)
        sink.close()
    serve_wall = time.monotonic() - t0

    train_report, _ = report_file(chaos["telemetry"])
    serve_report, _ = report_file(serve_tel)
    tf = train_report["report"]["faults"]
    sf = serve_report["report"]["faults"]
    statuses = {r["status"] for r in serve["reports"].values()}
    sites = set(tf["by_site"]) | set(sf["by_site"])
    summary = {
        "seed": seed,
        "basech": basech,
        "device": dev.type,
        "twin": twin,
        "chaos": chaos,
        "restore": restore,
        "serve": serve,
        "serve_wall_s": round(serve_wall, 3),
        "serve_telemetry": serve_tel,
        "params_max_rel_diff": params_diff,
        "params_bitwise": params_bitwise,
        "loss_series_max_rel_diff": loss_diff,
        "loss_steps_compared": len(common),
        "faults": {
            "injected": tf["injected"] + sf["injected"],
            "recovered": tf["recovered"] + sf["recovered"],
            "unrecovered": tf["unrecovered"] + sf["unrecovered"],
            "sites": sorted(sites),
            "train": tf,
            "serve": sf,
        },
        "checks": {
            "params_match": params_diff <= 1e-5,
            # the skipped steps may be absent from the chaos series; all the
            # others must be present and agree
            "loss_series_match": loss_diff <= 1e-5 and len(common) >= ITERATIONS - 2,
            "all_faults_recovered": tf["unrecovered"] == 0 and sf["unrecovered"] == 0,
            "enough_faults": tf["injected"] + sf["injected"] >= 5,
            "enough_sites": len(sites) >= 4,
            "restore_fell_back": bool(restore["fell_back"]),
            "rollback_carries_tag": chaos["rollbacks"] == 0 or chaos["last_bad_tag"] is not None,
            "statuses_classified": len(statuses) > 0 and None not in statuses,
            "all_requests_terminal": all(r["status"] is not None
                                         for r in serve["reports"].values()),
        },
    }
    summary["ok"] = all(summary["checks"].values())
    summary["recovery_overhead_frac"] = round(chaos["wall_s"] / max(twin["wall_s"], 1e-9) - 1.0,
                                              4)
    return summary


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="the scripted chaos scenario (train -> restore "
                                            "-> serve under a seeded fault plan)")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fast", action="store_true", help="the half-width tier-1 profile")
    p.add_argument("--basech", type=int, default=None, help="model width (overrides --fast)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    summary = run_scenario(args.out, seed=args.seed, fast=args.fast, basech=args.basech,
                           device=args.device)
    with open(os.path.join(args.out, "CHAOS_SUMMARY.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    print(json.dumps({"ok": summary["ok"], "checks": summary["checks"],
                      "faults": {k: summary["faults"][k]
                                 for k in ("injected", "recovered", "unrecovered", "sites")},
                      "params_max_rel_diff": summary["params_max_rel_diff"],
                      "params_bitwise": summary["params_bitwise"],
                      "recovery_overhead_frac": summary["recovery_overhead_frac"]}))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
