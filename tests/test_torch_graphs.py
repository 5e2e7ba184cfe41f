"""The engine's program cache (``repro_torch.serving.graphs``) on the CPU.

What the CPU reaches of it: the signature key, the static-argument
identity check, the launch-count bookkeeping of a capture and its
replays (plain functions over count dicts), the eager path the CPU
takes, the replay checker, and the ``compile:`` spans of
``obs.traced_call`` held against the reference's ``traced_jit``. The
graphs themselves are captured and replayed only on the card
(``tests/test_torch_cuda.py``, ``cuda`` marker).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.kernels import ops
from repro_torch.layers.attention import KVCache
from repro_torch.models import registry
from repro_torch.obs import Tracer, traced_call
from repro_torch.quant.prepare import PreparedWeight
from repro_torch.serving import EngineConfig, Request, SamplingParams
from repro_torch.serving import graphs
from repro_torch.serving.engine import ServingEngine


def _carry(b=3, dtype=np.int32):
    z = np.zeros(b, dtype)
    return registry.DecodeCarry(
        tok=z, pos=z, rem=z, taken=z, stops=np.full((b, 4), -1, np.int32),
        temp=np.zeros(b, np.float32), top_k=z, top_p=np.ones(b, np.float32),
        keys=np.zeros((b, 2), np.int64))


# ---------------------------------------------------------------- trees

def test_leaves_walk_prepared_weights_caches_and_carries():
    w = PreparedWeight(torch.zeros(2, 4, dtype=torch.int8),
                       torch.ones(1, 4), "int8", torch.tensor(0.5))
    cache = KVCache(torch.zeros(1, 2), torch.ones(1, 2),
                    torch.full((1, 2), -1, dtype=torch.int32))
    tree = {"p": {"w": w, "b": [torch.zeros(3), None]}, "c": cache}
    paths = [p for p, _ in graphs.leaves(tree)]
    assert paths == [("p", "w", "data"), ("p", "w", "scale"),
                     ("p", "w", "kind"), ("p", "w", "act_scale"),
                     ("p", "b", 0), ("p", "b", 1),
                     ("c", "k"), ("c", "v"), ("c", "pos")]
    clone = graphs.clone_tree(tree)
    assert isinstance(clone["p"]["w"], PreparedWeight)
    assert isinstance(clone["c"], KVCache)
    assert clone["p"]["w"].kind == "int8"
    for (_, a), (_, b) in zip(graphs.leaves(tree), graphs.leaves(clone)):
        assert graphs.same_bits(a, b)
        if isinstance(a, torch.Tensor):
            assert a.data_ptr() != b.data_ptr()


def test_same_bits_compares_bit_patterns():
    assert graphs.same_bits(torch.tensor([float("nan")]),
                            torch.tensor([float("nan")]))
    assert not graphs.same_bits(torch.tensor([0.0]), torch.tensor([-0.0]))
    assert not graphs.same_bits(torch.zeros(2), torch.zeros(2, 1))
    assert not graphs.same_bits(torch.zeros(2), torch.zeros(2,
                                                             dtype=torch.half))
    assert graphs.same_bits(torch.tensor(3.0), torch.tensor(3.0))
    assert graphs.same_bits("int8", "int8") and not graphs.same_bits(1, 2)


# ------------------------------------------------------------ signature

def test_signature_keys_shapes_dtypes_and_python_values():
    key = graphs.signature((_carry(),))
    assert key == graphs.signature((_carry(),))
    # a tensor and a host array of one shape and dtype share a key
    tensors = _carry()._replace(tok=torch.zeros(3, dtype=torch.int32))
    assert graphs.signature((tensors,)) == key
    assert graphs.signature((_carry(b=4),)) != key           # shape
    assert graphs.signature((_carry(dtype=np.int64),)) != key  # dtype
    # a static Python argument keys by value
    tok = np.zeros((3, 1), np.int32)
    assert graphs.signature((tok, 2)) != graphs.signature((tok, 3))
    assert graphs.signature((tok, 2)) == graphs.signature((tok.copy(), 2))
    # the tree's paths are part of the key
    assert graphs.signature(({"a": tok},)) != graphs.signature(({"b": tok},))


# --------------------------------------------------- static arguments

def _static():
    return ({"w": torch.arange(6.0).reshape(2, 3)},
            {"b0": KVCache(torch.zeros(2, 4), torch.zeros(2, 4),
                           torch.full((2, 4), -1, dtype=torch.int32))})


def test_static_binding_refuses_a_swapped_tensor():
    params, caches = _static()
    binding = graphs.StaticBinding((params, caches))
    binding.check((params, caches), "p")
    # the same tensors in new containers pass: identity is by address
    binding.check((dict(params), dict(caches)), "p")
    swapped = dict(caches, b0=caches["b0"]._replace(k=caches["b0"].k.clone()))
    with pytest.raises(RuntimeError, match="b0/k"):
        binding.check((params, swapped), "p")
    view = dict(params, w=params["w"].t())              # strides and shape
    with pytest.raises(RuntimeError, match="static argument 0/w"):
        binding.check((view, caches), "p")
    with pytest.raises(RuntimeError, match="tree changed"):
        binding.check((params, caches, torch.zeros(1)), "p")


def test_program_on_the_cpu_is_the_eager_call():
    params, caches = _static()
    seen = []

    def fn(p, c, x, scale):
        seen.append(x)
        c["b0"].k.add_(x[:, None] * scale)
        return x * p["w"][0, 1], c

    programs = graphs.Programs(torch.device("cpu"))
    prog = programs.program(fn, 2, "toy")
    host = np.array([1.0, 2.0], np.float32)
    out, c = prog(params, caches, host, 1.0)
    host[:] = 7.0                        # the call holds a copy, no alias
    assert torch.equal(out, torch.tensor([1.0, 2.0]))
    assert c is caches and float(caches["b0"].k[1, 0]) == 2.0
    prog(params, caches, host, 1.0)
    prog(params, caches, host, 2.0)                  # a second signature
    prog(params, caches, host[:1], 2.0)              # a third
    assert prog._cache_size() == 3 and prog.replays == 0
    stats = programs.stats()
    assert stats["signatures"] == 3 and stats["captures"] == 0
    assert all(isinstance(x, torch.Tensor) for x in seen)
    swapped = dict(caches, b0=caches["b0"]._replace(v=torch.zeros(2, 4)))
    with pytest.raises(RuntimeError, match="b0/v"):
        prog(params, swapped, host, 1.0)
    with programs._eager_calls():                     # bypasses the cache
        prog(params, swapped, host, 5.0)
    assert prog._cache_size() == 3


# -------------------------------------------------- launch bookkeeping

def test_capture_delta_is_taken_back_and_added_per_replay():
    """A capture counts launches but launches nothing; each replay
    launches what it recorded: after warm-up, capture and two replays the
    tables read what three eager calls would."""
    tables = ({"qmm": 4, "qmm_packed": 0}, {"fused_qmm": 1,
                                            "fused_dequant_mm": 0})

    def counts():
        return {k: v for t in tables for k, v in t.items()}

    def one_call():                    # what one call of the program counts
        ops.add_launch_counts({"qmm": 2, "fused_dequant_mm": 3}, tables)

    start = counts()
    one_call()                                       # the eager warm-up
    before = counts()
    one_call()                                       # the capture
    delta = graphs.count_delta(before, counts())
    assert delta == {"qmm": 2, "fused_dequant_mm": 3}
    ops.add_launch_counts({k: -v for k, v in delta.items()}, tables)
    assert counts() == before
    for _ in range(2):                               # two replays
        ops.add_launch_counts(delta, tables)
    assert graphs.count_delta(start, counts()) == {"qmm": 6,
                                                   "fused_dequant_mm": 9}
    assert graphs.count_delta(counts(), counts()) == {}
    with pytest.raises(KeyError, match="mystery"):
        ops.add_launch_counts({"mystery": 1}, tables)


def test_wrapper_count_tables_take_deltas():
    before = ops.launch_counts()
    ops.add_launch_counts({"qmm": 3, "mp_matmul": 1})
    assert graphs.count_delta(before, ops.launch_counts()) == {
        "qmm": 3, "mp_matmul": 1}
    ops.add_launch_counts({"qmm": -3, "mp_matmul": -1})
    assert ops.launch_counts() == before


# ------------------------------------------------------- replay checker

def test_check_replay_finds_what_differs():
    params, caches = _static()
    programs = graphs.Programs(torch.device("cpu"))
    steady = programs.program(
        lambda p, c, x: (c["b0"].k.add_(x[:, None]), x + 1)[1:], 2, "steady")
    x = np.array([1.0, 2.0], np.float32)
    assert graphs.check_replay(steady, params, caches, x) == []
    calls = [0]

    def drifting(p, c, x):
        calls[0] += 1
        c["b0"].pos.fill_(calls[0])
        return x * calls[0]

    drift = programs.program(drifting, 2, "drift")
    assert graphs.check_replay(drift, params, caches, x) == [
        "out", "static/1/b0/pos"]


# ---------------------------------------------------------------- spans

class _Signatures:
    """A callable with a program cache of its argument values."""

    def __init__(self):
        self.seen = set()

    def _cache_size(self):
        return len(self.seen)

    def __call__(self, x):
        self.seen.add(x)
        return x


def _compile_spans(wrap, calls):
    tracer = Tracer(clock=iter(range(1000)).__next__)
    fn = wrap(_Signatures(), "prog", tracer)
    for x in calls:
        fn(x)
    return [(e["name"], e["ts"], e["dur"]) for e in tracer.events
            if e.get("cat") == "compile"]


def test_traced_call_spans_each_cache_growth_as_the_reference():
    from repro.obs.trace import traced_jit
    calls = ["a", "a", "b", "a", "c", "b"]
    spans = _compile_spans(traced_call, calls)
    assert [s[0] for s in spans] == ["compile:prog"] * 3
    assert spans == _compile_spans(traced_jit, calls)
    # without a cache size, the first call alone
    tracer = Tracer(clock=iter(range(100)).__next__)
    fn = traced_call(lambda x: x, "plain", tracer)
    for x in calls:
        fn(x)
    assert sum(e.get("cat") == "compile" for e in tracer.events) == 1
    raw = _Signatures()
    assert traced_call(raw, "off", Tracer(enabled=False)) is raw
    assert traced_call(raw, "on", tracer).__wrapped__ is raw


# --------------------------------------------------------------- engine

def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.rid: list(r.tokens) for r in reqs}


def _requests(cfg, sampled):
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab, int(rng.integers(2, 11)), dtype=np.int32),
                max_new_tokens=int(rng.integers(3, 8)),
                sampling=SamplingParams(temperature=0.8 if sampled and i % 2
                                        else 0.0, top_k=20))
            for i in range(5)]


@pytest.mark.parametrize("decode_block", [1, 3])
@pytest.mark.parametrize("sampled", [False, True])
def test_cpu_engine_takes_the_eager_path(decode_block, sampled):
    """On the CPU every program is the eager call: signatures, no graph,
    no replay; the private eager calls serve the same streams, and each
    program's replay check (eager against eager here) finds nothing."""
    cfg = dataclasses.replace(reduced("qwen2-0.5b"), n_layers=2,
                              precision_policy="int8_serving")
    api = registry.build(cfg)
    params = api.init(0, "cpu")
    config = EngineConfig(batch_slots=2, cache_len=32, prefill_chunk=4,
                          decode_block=decode_block, act_calibration="auto")
    eng = ServingEngine(cfg, api, params, config, device="cpu")
    streams = _serve(eng, _requests(cfg, sampled))
    stats = eng.metrics()["graphs"]
    assert stats["captures"] == stats["replays"] == 0
    names = {"prefill_chunk"} | ({"decode_step"} if decode_block == 1
                                 else set())
    assert names <= set(stats["programs"])
    assert stats["signatures"] >= len(names)
    eager = ServingEngine(cfg, api, params,
                          dataclasses.replace(
                              config, act_calibration=eng.act_scales),
                          device="cpu")
    with eager._graphs._eager_calls():
        assert _serve(eager, _requests(cfg, sampled)) == streams
    assert eager.metrics()["graphs"]["signatures"] == 0
    before = graphs.clone_tree(eng.caches)
    checks = eng._check_replays(sampled)
    assert set(checks) == {"prefill_chunk", "decode_step", "select",
                           f"block_decode[n={decode_block}]"}
    assert all(v == [] for v in checks.values()), checks
    for (_, a), (_, b) in zip(graphs.leaves(before),
                              graphs.leaves(eng.caches)):
        assert graphs.same_bits(a, b)          # the caches came back


def test_a_dropped_engine_frees_its_programs_at_once():
    """No reference cycle holds an engine or its programs: they go when
    the last reference does, not at a later garbage collection, which on
    the card could fall inside another engine's capture and destroy a
    graph there."""
    import gc
    import weakref
    cfg = dataclasses.replace(reduced("qwen2-0.5b"), n_layers=2,
                              precision_policy="int8_serving")
    api = registry.build(cfg)
    params = api.init(0, "cpu")
    collecting = gc.isenabled()
    gc.disable()
    try:
        for trace in (False, True):
            eng = ServingEngine(cfg, api, params, EngineConfig(
                batch_slots=2, cache_len=32, prefill_chunk=4, decode_block=3,
                act_calibration="auto", trace=trace), device="cpu")
            _serve(eng, _requests(cfg, True))
            refs = [weakref.ref(eng)] + [weakref.ref(p)
                                         for p in eng._graphs.programs]
            del eng
            assert all(r() is None for r in refs), trace
    finally:
        if collecting:
            gc.enable()
