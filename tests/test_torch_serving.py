"""The port's ``ServingEngine`` against the JAX reference's, on the CPU.

Both engines serve ``reduced("qwen2-0.5b")`` on the same converted
weights and the same calibrated act scales, through one bursty trace
(``tests/_jax_reference.py``: a multi-wave prompt, arrivals that land
mid-decode, an oversized request, stop ids that fire mid-block). Greedy
streams are held EQUAL, token for token, and so are the engine counters
(``host_syncs``, ``short_blocks``, ``mid_block_admits``, ``eos_stops``
and the rest), finish reasons, truncation flags and the per-step
weight-quant, act-quant and staged-operand counts. One case admits by
teacher forcing (``prefill="teacher"``: one decode step per prompt
token, every other slot fed the pad token), and its streams equal the
chunked-prefill ones.

Sampled streams cannot match ``jax.random``; they are held to the
port's own contract instead: the same seed gives the same stream, and
the stream does not depend on ``decode_block``.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import registry
from repro_torch.serving import EngineConfig, Request, SamplingParams
from repro_torch.serving.engine import ServingEngine

from _jax_reference import (ENGINE_CASES, STOPS, TRACE, drive_trace,
                             trace_prompts)
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from _torch_parity import reference


@pytest.fixture(scope="module")
def ref():
    out = reference("serving")
    return out, params_from_numpy(out["params"], device="cpu")


def _engine(params, policy, scales, **kw):
    cfg = dataclasses.replace(reduced("qwen2-0.5b"), precision_policy=policy)
    config = EngineConfig(batch_slots=2, cache_len=64, prefill_chunk=4,
                          act_calibration=scales, **kw)
    return ServingEngine(cfg, registry.build(cfg), params, config=config,
                         device="cpu")


def _greedy(rid, prompt, budget, stops):
    return Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                   sampling=SamplingParams(stop_ids=stops))


_RUNS = {}


def _serve(ref, name):
    """The port engine over the trace for one case (once per module)."""
    if name not in _RUNS:
        out, params = ref
        policy, kw = ENGINE_CASES[name]
        _RUNS[name] = drive_trace(
            lambda: _engine(params, policy, out["scales"][policy], **kw),
            _greedy, STOPS)
    return _RUNS[name]


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_matches_reference(ref, name):
    want = ref[0]["cases"][name]
    eng, streams = _serve(ref, name)
    assert streams == want["streams"]
    assert dict(eng.counters) == want["counters"]
    assert {r.rid: r.finish_reason for r in eng.completed.values()} \
        == want["finish"]
    assert {r.rid: r.truncated for r in eng.completed.values()} \
        == want["truncated"]
    assert eng.fused == want["fused"]
    assert eng.weight_quant_trace_count() == want["weight_quant"] == 0
    assert eng.act_quant_trace_count() == want["act_quant"] == 0
    assert eng.staged_trace_count() == want["staged"]
    # on the CPU each program is the eager call: signatures, no graphs
    programs = eng.metrics()["graphs"]
    assert programs["captures"] == programs["replays"] == 0
    # a prefill wave and a decode step; teacher forcing needs no wave
    assert programs["signatures"] >= (2 if eng._fast_prefill else 1)


def test_fused_on_and_off_identical_under_exact_int(ref):
    on, off = _serve(ref, "fid_on"), _serve(ref, "fid_off")
    assert on[0].fused and not off[0].fused
    assert on[1] == off[1]
    assert off[0].staged_trace_count() == on[0].staged_trace_count() == 0
    assert on[0].counters["eos_stops"] > 0
    assert on[0].counters["mid_block_admits"] > 0


def test_greedy_streams_invariant_to_decode_block(ref):
    base = _serve(ref, "int8_b1")[1]
    for name in ("int8_b2", "int8_b3", "int8_b8"):
        assert _serve(ref, name)[1] == base, name


def _sampled(params, scales, decode_block, seed_of=None):
    def make(rid, prompt, budget, stops):
        return Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                       sampling=SamplingParams(
                           temperature=0.9, top_k=40, top_p=0.95,
                           stop_ids=stops,
                           seed=None if seed_of is None else seed_of(rid)))
    return drive_trace(
        lambda: _engine(params, "int8_serving", scales,
                        decode_block=decode_block),
        make, STOPS)[1]


def test_sampled_streams_seeded_and_block_invariant(ref):
    out, params = ref
    scales = out["scales"]["int8_serving"]
    a = _sampled(params, scales, 1)
    assert a == _sampled(params, scales, 1)
    assert a == _sampled(params, scales, 4)
    pinned = _sampled(params, scales, 3, seed_of=lambda rid: 1000 + rid)
    assert pinned == _sampled(params, scales, 1,
                              seed_of=lambda rid: 1000 + rid)
    assert pinned != a
    greedy = _serve(ref, "int8_b1")[1]
    assert a != greedy
    prompts = trace_prompts()
    for rid, (n, budget, _) in TRACE.items():
        assert a[rid][:n] == list(prompts[rid])
        assert n < len(a[rid]) <= n + budget


def test_engine_metrics_and_weight_bytes(ref):
    eng, _ = _serve(ref, "int8_b3")
    m = eng.metrics()
    assert m["n"] == 5 and m["device"] == "cpu"
    assert m["prepared_weights"] and m["act_calibrated"]
    wb = eng.weight_bytes()
    assert set(wb["by_kind"]) == {"int8"}
    raw = 4 * sum(int(np.prod(w.data.shape))
                  for w in _projection_leaves(eng))
    assert wb["projections"] <= 0.3 * raw
    assert m["ttft_s"]["max"] >= 0


def test_routing_report_and_trace_spans(ref, tmp_path):
    """One decode step routes every projection by the policy, and a
    traced engine spans the first call of each program signature as
    ``compile:<name>``."""
    import json
    out, params = ref
    eng, _ = _serve(ref, "int4_off_b4")
    report = eng.routing_report()
    assert len(report) == 7 and set(report.values()) == {"int4"}
    traced = _engine(params, "int8_serving", out["scales"]["int8_serving"],
                     decode_block=2, trace=True)
    traced.submit(_greedy(0, np.arange(1, 7, dtype=np.int32), 3, ()))
    traced.run_until_drained()
    events = json.load(open(traced.dump_trace(str(tmp_path / "t.json"))))
    names = [e["name"] for e in events["traceEvents"]]
    assert {"compile:prefill_chunk",
            "compile:block_decode[n=2,greedy]"} <= set(names)
    # one span per signature: each program here has one
    assert names.count("compile:prefill_chunk") == 1
    assert names.count("compile:block_decode[n=2,greedy]") == 1
    assert {"admission", "prefill_dispatch", "block_dispatch"} <= set(names)


def _projection_leaves(eng):
    from repro_torch.quant.prepare import iter_projection_weights
    return [w for _, w in iter_projection_weights(
        eng.params, registry.projection_paths(eng.cfg))]


def test_teacher_forced_streams_equal_chunked(ref):
    """qwen2 under ``prefill="teacher"`` serves the trace with the same
    greedy streams as under chunked prefill, with no prefill wave and a
    teacher-forced step (and host sync) per prompt token but the last."""
    teacher, streams = _serve(ref, "int8_teacher")
    chunked, base = _serve(ref, "int8_b1")
    assert streams == base
    c, c1 = teacher.counters, chunked.counters
    assert c["prefill_calls"] == c["prefill_tokens"] == 0
    assert c["teacher_forced_tokens"] == c1["prefill_tokens"] == sum(
        n - 1 for n, _, _ in TRACE.values())
    # one sync a decode step (decode_block 1) and one a forced token
    assert c["host_syncs"] == c["decode_steps"] + c["teacher_forced_tokens"]
    assert c1["host_syncs"] == c1["decode_steps"]
    assert "prefill_chunk" not in teacher.metrics()["graphs"]["programs"]


def test_matches_teacher_forced_admission(ref):
    """Mirror of ``tests/test_serving.py::
    test_matches_teacher_forced_admission``: chunked waves and teacher
    forcing leave the same per-slot cache prefix, positions and next
    inputs, and the first decode step sees the same distribution (the
    reference's tolerances: 0.05 on caches, 0.1 on logits)."""
    import torch
    from repro_torch.convert import to_numpy
    cfg = dataclasses.replace(reduced("qwen2-0.5b"), precision_policy="bf16")
    api = registry.build(cfg)
    lengths = [5, 1, 9]          # mixed: one slot needs no prefill
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in lengths]
    engines = {}
    for mode in ("batched", "teacher"):
        eng = ServingEngine(cfg, api, ref[1], config=EngineConfig(
            batch_slots=3, cache_len=64, prefill=mode, prefill_chunk=4),
            device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=2))
        eng._admit()
        while eng._prefill_tick():   # drain the chunked waves
            pass
        engines[mode] = eng
    fast, slow = engines["batched"], engines["teacher"]
    assert np.array_equal(fast.pos, slow.pos)
    # 4 + 8 prompt tokens at chunk 4: two packed waves
    assert fast.counters["prefill_calls"] == 2
    assert slow.counters["teacher_forced_tokens"] == sum(
        n - 1 for n in lengths)
    for name in fast.caches:
        for lf, ls in zip(to_numpy(fast.caches[name]),
                          to_numpy(slow.caches[name])):
            for slot, n in enumerate(lengths):
                if n > 1:
                    np.testing.assert_allclose(
                        lf[:, slot, :n - 1], ls[:, slot, :n - 1],
                        rtol=0.05, atol=0.05)
    tok = np.zeros((fast.b, 1), np.int32)
    for s_ in range(fast.b):
        tok[s_, 0] = fast.slot_req[s_].next_input
        assert fast.slot_req[s_].next_input == slow.slot_req[s_].next_input

    def first_logits(eng):
        with torch.no_grad():
            logits, _ = eng._decode(eng.params, eng.caches, tok, eng.pos)
        return logits.numpy()

    np.testing.assert_allclose(first_logits(fast), first_logits(slow),
                               rtol=0.1, atol=0.1)
