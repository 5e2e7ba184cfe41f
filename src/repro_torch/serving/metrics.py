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

``slo_report`` layers the serving-quality view on top: SLO attainment
(the share of requests whose TTFT meets a deadline) and goodput (the
generated tokens of attaining requests per second).

"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

from repro_torch.obs.registry import PERCENTILES, percentile_block
from repro_torch.serving.engine import Request

__all__ = ["PERCENTILES", "percentiles", "request_metrics",
           "summarize_requests", "slo_report"]


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


def slo_report(reqs: Iterable[Request], ttft_slo_s: float) -> Dict:
    """SLO attainment and goodput over a set of requests.

    A request attains when its TTFT (submit -> first token) is at most
    ``ttft_slo_s``; requests that never produced a token are left out of
    the denominator. Goodput counts the generated tokens of attaining
    requests over the span from the earliest submit to the latest
    finish, or, while nothing has finished, to the latest first token
    (a partial rate over the tokens so far). ``completed`` counts the
    requests that finished."""
    rows = [r for r in reqs if r.first_token_time is not None]
    if not rows:
        return {"n": 0, "completed": 0, "ttft_slo_s": float(ttft_slo_s),
                "attainment": None, "goodput_tok_per_s": None}
    attain = [r for r in rows
              if (r.first_token_time - r.submit_time) <= ttft_slo_s]
    finished = [r.finish_time for r in rows if r.finish_time is not None]
    t0 = min(r.submit_time for r in rows)
    t1 = max(finished) if finished \
        else max(r.first_token_time for r in rows)
    span = max(t1 - t0, 1e-9)
    good = sum(len(r.tokens) - len(r.prompt) for r in attain)
    return {
        "n": len(rows),
        "completed": len(finished),
        "ttft_slo_s": float(ttft_slo_s),
        "attainment": len(attain) / len(rows),
        "goodput_tok_per_s": good / span,
    }
