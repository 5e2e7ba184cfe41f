"""Summarize a serving-engine Chrome trace on the terminal (mirror of
``tools/trace_report.py``; prints the same text on the same trace).

``ServingEngine.dump_trace(path)`` (``EngineConfig(trace=True)``)
exports Chrome trace-event JSON — load it graphically at
https://ui.perfetto.dev or ``chrome://tracing``, or render the same
file as a terminal summary here:

    PYTHONPATH=src python -m repro_torch.tools.trace_report /tmp/trace.json

The report validates the schema first (``repro_torch.obs.trace.
validate_chrome_trace``, non-zero exit on errors), then prints:

  * per-phase totals of the engine-tick lane (admission / prefill
    dispatch / block dispatch / host sync / harvest): count, total and
    mean duration, share of the traced wall span;
  * compile events (``cat="compile"`` spans of the engine's program
    cache), with the cost of each compilation;
  * request lanes: per-stage durations (queued / prefill / decode) of
    each request's B/E pairs and its first-token/finished instants;
  * the top individual spans by duration.
"""
import argparse
import collections
import json
import sys

from repro_torch.obs.trace import REQUEST_LANE_BASE, validate_chrome_trace


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.2f}ms"
    return f"{us:.0f}us"


def load_events(path: str):
    with open(path) as f:
        data = json.load(f)
    errors = validate_chrome_trace(data)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return events, errors


def phase_table(events):
    """name -> (count, total_us) over complete spans of the tick lane."""
    table = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") == "compile":
            continue
        if ev.get("tid", 0) >= REQUEST_LANE_BASE:
            continue
        n, tot = table.get(ev["name"], (0, 0.0))
        table[ev["name"]] = (n + 1, tot + float(ev.get("dur", 0.0)))
    return table


def compile_events(events):
    return [ev for ev in events if ev.get("cat") == "compile"]


def request_lanes(events):
    """tid -> {stage: duration_us, instants: [...]} from B/E pairs."""
    lanes = collections.defaultdict(
        lambda: {"stages": {}, "instants": [], "name": None})
    open_spans = {}
    for ev in events:
        tid = ev.get("tid", 0)
        if tid < REQUEST_LANE_BASE:
            continue
        lane = lanes[tid]
        ph = ev.get("ph")
        if ph == "M" and ev.get("name") == "thread_name":
            lane["name"] = ev.get("args", {}).get("name")
        elif ph == "B":
            open_spans[(tid, ev["name"])] = float(ev["ts"])
        elif ph == "E":
            t0 = open_spans.pop((tid, ev["name"]), None)
            if t0 is not None:
                lane["stages"][ev["name"]] = float(ev["ts"]) - t0
        elif ph == "i":
            lane["instants"].append(ev["name"])
    return dict(lanes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="trace_report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", help="Chrome trace-event JSON "
                                 "(engine.dump_trace output)")
    ap.add_argument("--top", type=int, default=5,
                    help="longest individual spans to list")
    args = ap.parse_args(argv)

    events, errors = load_events(args.path)
    if errors:
        print(f"INVALID trace ({len(errors)} schema errors):")
        for e in errors[:10]:
            print(f"  {e}")
        return 1
    if not events:
        print("empty trace")
        return 1

    xs = [ev for ev in events if ev.get("ph") == "X"]
    spanned = [float(ev["ts"]) for ev in events if ev.get("ph") != "M"]
    wall = (max(spanned) - min(spanned)) if len(spanned) > 1 else 0.0
    print(f"{args.path}: {len(events)} events, "
          f"{len(xs)} complete spans, wall {_fmt_us(wall)}")

    print("\ntick phases:")
    table = phase_table(events)
    for name, (n, tot) in sorted(table.items(), key=lambda kv: -kv[1][1]):
        share = 100.0 * tot / wall if wall > 0 else 0.0
        print(f"  {name:<18} n={n:<6} total={_fmt_us(tot):>9} "
              f"mean={_fmt_us(tot / n):>9}  {share:5.1f}% of wall")

    comp = compile_events(events)
    print(f"\ncompile events ({len(comp)}):")
    for ev in comp:
        dur = ev.get("dur")
        cost = f" {_fmt_us(float(dur))}" if dur is not None else ""
        print(f"  {ev['name']}{cost}")

    lanes = request_lanes(events)
    print(f"\nrequest lanes ({len(lanes)}):")
    for tid in sorted(lanes):
        lane = lanes[tid]
        stages = "  ".join(f"{k}={_fmt_us(v)}"
                           for k, v in lane["stages"].items())
        inst = (" | " + ", ".join(lane["instants"])
                if lane["instants"] else "")
        print(f"  {lane['name'] or tid}: {stages}{inst}")

    print(f"\ntop {args.top} spans:")
    for ev in sorted(xs, key=lambda e: -float(e.get("dur", 0)))[:args.top]:
        print(f"  {_fmt_us(float(ev['dur'])):>9}  {ev['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
