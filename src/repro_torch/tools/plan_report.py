"""Render a precision plan (``precision-plan-v1`` JSON) as a markdown
Pareto report (mirror of ``tools/plan_report.py``; prints the same text
on the same plan).

    PYTHONPATH=src python -m repro_torch.tools.plan_report PLAN.json
    PYTHONPATH=src python -m repro_torch.tools.plan_report P.json --out R.md
"""
import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("plan", help="PrecisionPlan JSON artifact")
    ap.add_argument("--out", default=None,
                    help="write markdown here instead of stdout")
    args = ap.parse_args(argv)

    from repro_torch.autotune.cli import cmd_report
    return cmd_report(["--plan", args.plan]
                      + (["--out", args.out] if args.out else []))


if __name__ == "__main__":
    raise SystemExit(main())
