"""``python -m repro_torch.analysis``: the port's static-analysis entry
point (the reference's ``python -m repro.analysis``).

Runs both layers and exits non-zero on any finding:

1. the hazard linter (``RT001``..) over ``src/repro_torch`` (or the
   paths given), its Python and CUDA sources;
2. the comm-schedule verifier over ``grids.full_grid()`` (the pipeline
   conformance grid and the prune-axis grid).

``--report PATH`` writes the machine-readable report as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import grids
from repro_torch.analysis.lint import RULES, lint_paths
from repro_torch.analysis.schedule_verifier import ConfigError, verify_schedule


def _default_root() -> str:
    return str(Path(__file__).resolve().parents[1])    # src/repro_torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static comm-schedule verifier + PyTorch/CUDA linter")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: the repro_torch "
                         "package)")
    ap.add_argument("--report", metavar="PATH", default=None,
                    help="write the JSON report here")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the hazard linter")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the schedule-verifier grids")
    ap.add_argument("--rules", action="store_true",
                    help="print the lint rule table and exit")
    args = ap.parse_args(argv)

    if args.rules:
        for rule in RULES.values():
            print(f"{rule.code}  {rule.name:<27} {rule.summary}")
        return 0

    failed = False
    report = {"lint": None, "verifier": None}

    if not args.no_lint:
        diags, n_files = lint_paths(args.paths or [_default_root()])
        for d in diags:
            print(d.format())
        print(f"lint: {len(diags)} finding(s) over {n_files} file(s)")
        report["lint"] = {
            "n_files": n_files,
            "n_findings": len(diags),
            "findings": [{"path": d.path, "line": d.line, "col": d.col,
                          "code": d.code, "message": d.message}
                         for d in diags],
            "rules": {r.code: {"name": r.name, "summary": r.summary}
                      for r in RULES.values()},
        }
        failed |= bool(diags)

    if not args.no_verify:
        cells = grids.full_grid()
        unsafe, errors = [], []
        for cfg in cells:
            try:
                rep = verify_schedule(cfg)
            except ConfigError as e:
                errors.append({"config": repr(cfg), "error": str(e)})
                continue
            if not rep.safe:
                unsafe.append(rep)
        print(f"verifier: {len(cells)} grid config(s), "
              f"{len(unsafe)} unsafe, {len(errors)} rejected")
        for rep in unsafe:
            print(rep.summary())
            print(rep.counterexample())
        for err in errors:
            print(f"rejected: {err['config']}: {err['error']}")
        report["verifier"] = {
            "n_configs": len(cells),
            "all_safe": not unsafe and not errors,
            "unsafe": [rep.to_dict() for rep in unsafe],
            "config_errors": errors,
        }
        failed |= bool(unsafe) or bool(errors)

    if args.report:
        out = Path(args.report)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2, sort_keys=True))
        print(f"report written to {out}")

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
