"""CLI: ``python -m esr_tpu_torch.obs <export|report|drift> ...`` (the
subcommands of ``python -m esr_tpu.obs``).

- ``export telemetry.jsonl [more.jsonl ...] [-o trace.json]``: Chrome
  trace-event / Perfetto JSON (``obs/export.py``); several files (a
  fleet's router and replica files, optionally ``label=path``) merge into
  one trace with a process group per file.
- ``report telemetry.jsonl [more.jsonl ...] [--slo configs/slo.yml]
  [-o report.json]``: one file gives its run's rollup; several merge into
  one fleet rollup with a per-replica ``replicas`` section, and the SLO
  gates the fleet view.
- ``drift [--dtype bf16] [--break-tag TAG] [--fail-on-drift] [--device
  cpu]``: the precision-drift harness (``obs/numerics.py``): one seeded
  batch through an f32 model and a candidate-dtype twin, the per-tag
  relative-error ladder naming the first layer over tolerance. It runs on
  the card unless ``--device cpu``.

``export`` and ``report`` take ``--run-index N`` for a run of an appended
multi-run file (default -1, the last). Exit codes: 0 ok or every SLO rule
passed, 1 a violation (or a drift offender under ``--fail-on-drift``), 2 a
usage error or an unreadable input.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

_RUN_INDEX_HELP = ("which run of an appended multi-run file (0-based; negative counts "
                   "from the end; default -1 = last run)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m esr_tpu_torch.obs",
        description="telemetry.jsonl tooling: Perfetto export, the SLO-gated run reporter "
                    "and the precision-drift harness",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="convert telemetry.jsonl to Perfetto/Chrome JSON")
    ex.add_argument("telemetry", nargs="+",
                    help="telemetry.jsonl path(s); several (optionally `label=path`) merge "
                         "into one trace with a process group per file")
    ex.add_argument("-o", "--out", default=None,
                    help="output path (default: <telemetry>.trace.json)")
    ex.add_argument("--run-index", type=int, default=-1, help=_RUN_INDEX_HELP)

    rp = sub.add_parser("report", help="roll up a run and (optionally) gate it on an SLO")
    rp.add_argument("telemetry", nargs="+",
                    help="telemetry.jsonl path(s); several (optionally `label=path`, a "
                         "fleet's router + replica files) merge into one fleet-level "
                         "rollup with a per-replica `replicas` section")
    rp.add_argument("--slo", default=None, metavar="YAML",
                    help="SLO thresholds (e.g. configs/slo.yml); exit 1 on violation")
    rp.add_argument("-o", "--out", default=None, help="also write the JSON document here")
    rp.add_argument("--run-index", type=int, default=-1, help=_RUN_INDEX_HELP)

    dr = sub.add_parser("drift", help="precision-drift attribution: f32 vs a candidate-dtype "
                                      "twin, per-layer relative-error ladder")
    dr.add_argument("--dtype", default="bfloat16",
                    help="candidate dtype (bf16/f16/f32 spellings accepted; int8 reruns the "
                         "f32 feed under the PTQ seam quantization)")
    dr.add_argument("--basech", type=int, default=8, help="model base channel count")
    dr.add_argument("--hw", type=int, default=32, help="square spatial size of the batch")
    dr.add_argument("--frames", type=int, default=3, help="window length (num_frame)")
    dr.add_argument("--batch", type=int, default=1)
    dr.add_argument("--seed", type=int, default=0)
    dr.add_argument("--tolerance", type=float, default=0.25,
                    help="per-tag relative-error threshold naming an offender")
    dr.add_argument("--break-tag", default=None, metavar="TAG",
                    help="route this probe tag through the precision breaker (the "
                         "harness must then name exactly it)")
    dr.add_argument("--fail-on-drift", action="store_true",
                    help="exit 1 when any tag exceeds tolerance")
    dr.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dr.add_argument("-o", "--out", default=None, help="also write the JSON document here")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "export":
        from esr_tpu_torch.obs.export import export_file, export_files
        from esr_tpu_torch.obs.report import split_label

        out = args.out or (split_label(args.telemetry[0])[1] + ".trace.json")
        try:
            if len(args.telemetry) == 1 and "=" not in args.telemetry[0]:
                stats = export_file(args.telemetry[0], out, run_index=args.run_index)
            else:
                stats = export_files(args.telemetry, out, run_index=args.run_index)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(json.dumps(stats))
        return 0

    if args.cmd == "drift":
        from esr_tpu_torch.obs.numerics import run_drift

        try:
            doc = run_drift(dtype=args.dtype, basech=args.basech, hw=args.hw,
                            frames=args.frames, batch=args.batch, seed=args.seed,
                            tolerance=args.tolerance, break_tag=args.break_tag,
                            device=args.device)
        except (TypeError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if args.out is not None:
            with open(args.out, "w") as f:
                json.dump(doc, f, indent=2)
        print(json.dumps(doc, indent=2))
        return 1 if args.fail_on_drift and doc["first_offender"] is not None else 0

    from esr_tpu_torch.obs.report import report_files

    try:
        doc, code = report_files(args.telemetry, args.slo, args.out, run_index=args.run_index)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(doc, indent=2))
    return code


if __name__ == "__main__":
    sys.exit(main())
