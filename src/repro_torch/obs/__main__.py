"""``python -m repro_torch.obs`` — render or gate observability artifacts.

Two subcommands (``export`` is the default when the first argument is a
metrics JSONL path):

* ``export METRICS.jsonl [--out trace.json] [--steps N]`` — build the
  Chrome/Perfetto trace with measured + predicted lanes (open at
  https://ui.perfetto.dev).
* ``gate --baseline BASELINE.json --current NEW.json`` — the drift
  check; exits nonzero and prints each finding when the current run
  left the baseline's tolerance envelope.

The port of the JAX package's CLI: the same subcommands, outputs and exit
codes.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.gate import gate_files
from repro_torch.obs.perfetto import export_trace


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] not in ("export", "gate", "-h", "--help"):
        argv.insert(0, "export")

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="observability CLI: Perfetto export + perf gate")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("export", help="metrics JSONL -> trace.json")
    ex.add_argument("jsonl", help="metrics JSONL from a MetricsRegistry")
    ex.add_argument("--out", default="trace.json",
                    help="output trace path (default: trace.json)")
    ex.add_argument("--steps", type=int, default=8,
                    help="predicted-lane steps when no step counters "
                         "were recorded (default: 8)")

    ga = sub.add_parser("gate", help="drift-check a bench file")
    ga.add_argument("--baseline", required=True,
                    help="checked-in bench baseline (JSON)")
    ga.add_argument("--current", required=True,
                    help="freshly generated bench file")

    args = ap.parse_args(argv)
    if args.cmd == "export":
        trace = export_trace(args.jsonl, args.out, n_steps=args.steps)
        print(f"wrote {args.out}: {len(trace['traceEvents'])} events "
              f"({args.jsonl}: {trace['otherData']['n_records']} records)")
        return 0

    problems = gate_files(args.baseline, args.current)
    for p in problems:
        print(f"perf-gate: {p}")
    print(f"perf-gate: {len(problems)} finding(s) "
          f"({args.current} vs {args.baseline})")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
