"""Per-request serving metrics: TTFT, queue delay, throughput.

Everything is computed from the four timestamps the engine stamps on a
``Request`` (submit/admit/first-token/finish) and returned as plain
dicts — the schema benches serialize into ``BENCH_serving.json`` and
tests assert on.

Schema (``summarize_requests``)::

    {"n": int, "new_tokens": int,
     "ttft_s":        <percentile block>,
     "queue_delay_s": <percentile block>,
     "e2e_s":         <percentile block>,
     "tok_per_s_per_request": <percentile block>}

where ``<percentile block>`` is the canonical summary defined once in
``repro_torch.obs.registry`` (one ``p<N>`` key per entry of ``PERCENTILES``
plus ``mean``/``max``; ``{}`` when no request carries the timestamps —
e.g. nothing completed yet). ``PERCENTILES`` and the block function are
re-exported here for backward compatibility.

"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

from repro_torch.obs.registry import PERCENTILES, percentile_block
from repro_torch.serving.engine import Request

__all__ = ["PERCENTILES", "percentiles", "request_metrics",
           "summarize_requests"]


def percentiles(values: Sequence[float],
                ps: Sequence[int] = PERCENTILES) -> Dict[str, float]:
    """Summary block of a sample; ``{}`` for an empty sample. Alias of
    :func:`repro_torch.obs.registry.percentile_block` (the canonical home)."""
    return percentile_block(values, ps)


def request_metrics(req: Request) -> Dict[str, Optional[float]]:
    """Latency decomposition of one request (None where not measured)."""
    new = 0 if req.tokens is None else len(req.tokens) - len(req.prompt)

    def span(a, b):
        return None if a is None or b is None else max(b - a, 0.0)

    e2e = span(req.submit_time, req.finish_time)
    gen = span(req.admit_time, req.finish_time)
    return {
        "ttft_s": span(req.submit_time, req.first_token_time),
        "queue_delay_s": span(req.submit_time, req.admit_time),
        "e2e_s": e2e,
        "new_tokens": new,
        "tok_per_s": (new / gen) if gen else None,
    }


def summarize_requests(reqs: Iterable[Request]) -> Dict:
    """Aggregate percentile blocks over a set of (completed) requests."""
    rows = [request_metrics(r) for r in reqs]
    return {
        "n": len(rows),
        "new_tokens": int(sum(r["new_tokens"] for r in rows)),
        "ttft_s": percentiles([r["ttft_s"] for r in rows]),
        "queue_delay_s": percentiles([r["queue_delay_s"] for r in rows]),
        "e2e_s": percentiles([r["e2e_s"] for r in rows]),
        "tok_per_s_per_request": percentiles(
            [r["tok_per_s"] for r in rows]),
    }
