"""CLI: ``python -m esr_tpu_torch.obs report telemetry.jsonl [more.jsonl ...]
[--slo configs/slo.yml] [-o report.json] [--run-index N]`` (the ``report``
subcommand of ``python -m esr_tpu.obs``).

One file gives its run's rollup; several (a fleet's router and replica
files, optionally ``label=path``) merge into one fleet rollup with a
per-replica ``replicas`` section, and the SLO gates the fleet view.
``--run-index`` selects a run of an appended multi-run file (default -1,
the last). Exit codes: 0 every SLO rule passed, 1 a violation, 2 a usage
error or an unreadable input.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m esr_tpu_torch.obs",
        description="telemetry.jsonl tooling: the SLO-gated run reporter",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="roll up a run and (optionally) gate it on an SLO")
    rp.add_argument("telemetry", nargs="+",
                    help="telemetry.jsonl path(s); several (optionally `label=path`, a "
                         "fleet's router + replica files) merge into one fleet-level "
                         "rollup with a per-replica `replicas` section")
    rp.add_argument("--slo", default=None, metavar="YAML",
                    help="SLO thresholds (e.g. configs/slo.yml); exit 1 on violation")
    rp.add_argument("-o", "--out", default=None, help="also write the JSON document here")
    rp.add_argument("--run-index", type=int, default=-1,
                    help="which run of an appended multi-run file (0-based; negative "
                         "counts from the end; default -1 = last run)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
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
