"""The vlm, rwkv and griffin families against the JAX reference, on the CPU.

``internvl2-1b`` (the lm under a patch projector), ``rwkv6-1.6b`` (the
RWKV-6 time and channel mix, chunked prefill and the O(1) recurrence)
and ``recurrentgemma-9b`` (RG-LRU blocks with their associative scan
and causal conv, local MQA attention, GeGLU), each at ``reduced()``
size with the reference's converted weights.

* Configs and the init tree (paths, shapes, dtypes) equal the
  reference's.
* Forward, under ``bf16``, ``int8_serving`` and ``int4_serving`` with
  both executor variants: prefill logits and new state (vlm with
  patches), then three greedy decode steps from the REFERENCE's
  prefill state (converted), logits and final state.
* Calibration: the port's random calibration path equals the
  reference's on the same numpy batches (``calib_batch``, patches for
  vlm), and for rwkv and griffin so does calibration on prompts. With
  prompts a vlm's prefill has no patches and raises KeyError, in the
  reference too.
* Serving: the port's ``ServingEngine`` serves the bursty trace of
  ``tests/_jax_reference.py`` under ``int4_serving`` (calibrated,
  fused, ``prefill="auto"``, so admission is teacher-forced) with every
  counter, ``teacher_forced_tokens`` included, EQUAL to the reference
  engine's, at decode_block 1 for all three and 4 for vlm. Greedy
  streams are EQUAL for vlm and rwkv. For griffin they are equal up to
  near ties: a stream may leave the reference's only where the
  reference's token is the port's runner-up by less than
  ``GRIFFIN_TIE_ATOL`` (0.15) in logits. On this trace one does: the
  60-token request's 17th new token, runner-up by 0.026. The RG-LRU
  state is an f32 leaky integrator (decay up to 0.999 a step) fed by
  XLA's and torch's exp, tanh, sigmoid and log1p, which differ in the
  last bits (up to 59% of f32 inputs for tanh); once a bf16 rounding
  downstream of it falls the other way, the state carries the
  difference, and logits drift up to 0.11 over 70 decode steps at this
  size. The reference run op by op gives its jitted streams, so the
  drift is the two packages' transcendentals, not XLA's fusions.
* The engine's rules: ``prefill="batched"`` raises for the three,
  ``decode_block > 1`` for rwkv and griffin; decode state is written in
  place into real (never broadcast) tensors.

Tolerances. Logits 1e-5 absolute (|logit| < 5; the largest difference
seen is 4.8e-7, f32 summation order), except vlm's prefill logits:
5e-2, because the reduced model's patch sequence rounds one bf16 query
element (of 2560) the other way after a differently ordered f32 sum,
and one bf16 ulp moves its logits by up to 1.3e-2 (rwkv and griffin
prefill within 1e-5). States: bf16 leaves (KV caches, token shifts,
conv tails) within one bf16 ulp, the f32 recurrent states (the wkv
``s`` and RG-LRU ``h``) within 1e-5 relative to each leaf's largest
value, position tags exact. Scales exact; streams as above.

One reference subprocess per arch, all side by side
(``_torch_parity.references``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core.policy import get_policy
from repro_torch.layers.mplinear import executor_variant
from repro_torch.models import registry
from repro_torch.quant.calibrate import calibrate_act_scales
from repro_torch.serving import EngineConfig, Request, SamplingParams
from repro_torch.serving.engine import ServingEngine

from _jax_reference import (FAMILY_ARCHS, FAMILY_BLOCKS, FAMILY_POLICIES,
                            STOPS, TRACE, calib_batch, calib_prompts,
                            drive_trace, family_inputs)
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from _torch_parity import assert_state, flat, references

LOGIT_ATOL = 1e-5
VLM_PREFILL_LOGIT_ATOL = 5e-2
GRIFFIN_TIE_ATOL = 0.15
VARIANTS = (None, "fused")
SERVED = [(a, b) for a in FAMILY_ARCHS for b in FAMILY_BLOCKS[a]]


@pytest.fixture(scope="module")
def refs():
    out = references("family", FAMILY_ARCHS)
    return {a: (o, params_from_numpy(o["params"], device="cpu"))
            for a, o in out.items()}


def _cfg(arch, policy="bf16"):
    return dataclasses.replace(reduced(arch), precision_policy=policy)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_config_equals_the_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        ref_get_config(arch))
    assert dataclasses.asdict(reduced(arch)) == dataclasses.asdict(
        ref_reduced(arch))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_init_keeps_the_reference_tree(refs, arch):
    """``registry.init_params`` builds the reference's tree: the same
    paths (griffin's ``tail`` list included), shapes and dtypes."""
    out, _ = refs[arch]
    mine = flat(to_numpy(registry.init_params(reduced(arch), seed=1,
                                               device="cpu")))
    theirs = flat(out["params"])
    assert mine.keys() == theirs.keys()
    for k, v in theirs.items():
        assert (mine[k].shape, mine[k].dtype) == (v.shape, v.dtype), k


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_init_cache_keeps_the_reference_state(refs, arch):
    """A fresh decode state has the reference's tree, shapes and values
    (zeros; empty position tags), and every tensor owns its memory: an
    in-place write to one layer's state touches no other layer."""
    out, _ = refs[arch]
    api = registry.build(reduced(arch))
    state = api.init_cache(2, 16, "cpu")
    want = out["cases"][("bf16", None)]["prefill_state"]
    got = flat(state)
    assert got.keys() == flat(want).keys()
    for path, t in got.items():
        assert 0 not in t.stride(), path
        assert t.shape == np.asarray(flat(want)[path]).shape, path
        fill = -1 if path.endswith("pos") else 0
        assert bool((t == fill).all()), path
    ptrs = [t.data_ptr() for t in got.values()]
    assert len(set(ptrs)) == len(ptrs)


def _batch(inp):
    return {k: torch.from_numpy(v) for k, v in inp.items()}


def _prepared(refs, arch, policy):
    out, params = refs[arch]
    cfg = _cfg(arch, policy)
    api = registry.build(cfg)
    return api, api.prepare(params, get_policy(policy),
                            act_scales=out["scales"][policy])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("policy", FAMILY_POLICIES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_matches_reference(refs, arch, policy, variant):
    case = refs[arch][0]["cases"][(policy, variant)]
    api, prepared = _prepared(refs, arch, policy)
    inp = family_inputs(reduced(arch))
    with executor_variant(variant), torch.no_grad():
        logits, state = api.prefill(prepared, _batch(inp),
                                    api.init_cache(2, 16, "cpu"))
    atol = VLM_PREFILL_LOGIT_ATOL if arch == "internvl2-1b" else LOGIT_ATOL
    np.testing.assert_allclose(logits.numpy(), case["prefill_logits"],
                               rtol=0, atol=atol)
    assert_state(state, case["prefill_state"], "prefill")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("policy", FAMILY_POLICIES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_matches_reference(refs, arch, policy, variant):
    """Three decode steps from the reference's prefill state, each fed
    the reference's own greedy token; the state is updated in place."""
    case = refs[arch][0]["cases"][(policy, variant)]
    api, prepared = _prepared(refs, arch, policy)
    state = params_from_numpy(case["prefill_state"], device="cpu")
    leaves = [t.data_ptr() for t in flat(state).values()]
    tok = torch.from_numpy(np.argmax(case["prefill_logits"], -1)
                           .astype(np.int32)[:, None])
    pos = torch.full((2,), 12 + (reduced(arch).n_patches or 0),
                     dtype=torch.int32)
    with executor_variant(variant), torch.no_grad():
        for want in case["decode_logits"]:
            logits, out = api.decode_step(prepared,
                                          {"token": tok, "pos": pos}, state)
            assert [t.data_ptr() for t in flat(out).values()] == leaves
            np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                                       atol=LOGIT_ATOL)
            tok = torch.from_numpy(
                np.argmax(want, -1).astype(np.int32)[:, None])
            pos = pos + 1
    assert_state(state, case["decode_state"], "decode")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_calibration_batch_is_the_reference_batch(arch):
    cfg = reduced(arch)
    for seed in (0, 1):
        got = registry.calibration_batch(cfg, 2, 16, seed=seed)
        want = calib_batch(cfg, 2, 16, seed)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert ("patches" in got) == (cfg.family == "vlm")


@pytest.mark.parametrize("policy", ("int8_serving", "int4_serving"))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_calibrated_scales_match_reference(refs, arch, policy):
    """The random calibration path (two numpy batches of 2 x 16 tokens,
    patches for vlm) gives the reference's scales computed op by op
    (``jax.disable_jit``), and for rwkv and griffin so do the prompts.
    Jitted, the reference's griffin scales differ: for ``block/attn/w*``,
    ``block/mlp/w_gate``/``w_up`` and (int4) ``block/rec/w_in_*`` the
    jitted absmax is one bf16 ulp lower or higher than op by op (XLA
    rewrites the zero-centered RMSNorm's f32 arithmetic), as with
    stablelm in ``tests/test_torch_archs.py``. The forward and serving
    checks take the jitted scales on both sides."""
    out, params = refs[arch]
    cfg = _cfg(arch, policy)
    api = registry.build(cfg)
    got = calibrate_act_scales(cfg, api, params, device="cpu")
    assert got == out["eager_scales"][policy]
    if cfg.family != "griffin":
        assert got == out["scales"][policy]
    if cfg.family == "vlm":
        assert {"projector/fc1", "projector/fc2"} <= set(got)
    else:
        got = calibrate_act_scales(cfg, api, params, prompts=calib_prompts(),
                                   device="cpu")
        assert got == out["prompt_scales"][policy]
    # the gates and the decay LoRA ride raw f32 products, not mp_linear
    paths = registry.projection_paths(cfg)
    from repro_torch.quant.prepare import iter_projection_weights
    assert set(got) == {paths(p) for p, _ in
                        iter_projection_weights(params, paths)}


def test_vlm_calibration_on_prompts_raises_as_the_reference():
    """With prompts, the reference's calibration passes no patches and
    its vlm prefill raises KeyError; the port keeps that."""
    import jax

    from repro.models import registry as ref_registry
    from repro.quant.calibrate import calibrate_act_scales as ref_calibrate
    cfg = _cfg("internvl2-1b", "int8_serving")
    with pytest.raises(KeyError, match="patches"):
        calibrate_act_scales(cfg, registry.build(cfg),
                             registry.init_params(cfg, device="cpu"),
                             prompts=calib_prompts(), device="cpu")
    rcfg = dataclasses.replace(ref_reduced("internvl2-1b"),
                               precision_policy="int8_serving")
    rapi = ref_registry.build(rcfg)
    with pytest.raises(KeyError, match="patches"):
        ref_calibrate(rcfg, rapi, rapi.init(jax.random.PRNGKey(0)),
                      prompts=calib_prompts())


_RUNS = {}


class _Margins:
    """Records, for every token an engine generates at decode_block 1,
    the top-2 logit margin of the decode step that chose it and the
    runner-up: {rid: [(margin, runner-up), ...]}."""

    def __init__(self, eng):
        self.eng, self.margins, self.seen = eng, {}, {}
        self.decode, self.step = eng._decode, eng.step
        eng._decode, eng.step = self._decode_and_keep, self._step

    def _decode_and_keep(self, *args):
        logits, caches = self.decode(*args)
        self.logits = logits.clone()
        self.slots = {r.rid: s for s, r in enumerate(self.eng.slot_req)
                      if r is not None}
        return logits, caches

    def _step(self):
        out = self.step()
        reqs = [r for r in self.eng.slot_req if r is not None]
        for r in reqs + list(self.eng.completed.values()):
            n = len(r.tokens or ())
            if n > self.seen.get(r.rid, len(r.prompt)):
                top = torch.topk(self.logits[self.slots[r.rid]], 2)
                self.margins.setdefault(r.rid, []).append(
                    (float(top.values[0] - top.values[1]),
                     int(top.indices[1])))
                self.seen[r.rid] = n
        return out

    def restore(self):
        self.eng._decode = self.decode
        del self.eng.step


def _greedy(rid, prompt, budget, stops):
    return Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                   sampling=SamplingParams(stop_ids=stops))


def _serve(refs, arch, blk):
    if (arch, blk) not in _RUNS:
        out, params = refs[arch]
        cfg = _cfg(arch, "int4_serving")
        config = EngineConfig(batch_slots=2, cache_len=64, prefill_chunk=4,
                              decode_block=blk,
                              act_calibration=out["scales"]["int4_serving"])
        margins = []

        def make():
            eng = ServingEngine(cfg, registry.build(cfg), params,
                                config=config, device="cpu")
            if blk == 1:
                margins.append(_Margins(eng))
            return eng

        eng, streams = drive_trace(make, _greedy, STOPS)
        for m in margins:
            m.restore()
        _RUNS[(arch, blk)] = eng, streams, (margins or [None])[0]
    return _RUNS[(arch, blk)][:2]


def _assert_equal_up_to_near_ties(got, want, margins, what):
    """Streams equal, except that a stream may leave the reference's at
    a near tie: at its first differing token the reference's choice is
    the port's runner-up, by a margin under ``GRIFFIN_TIE_ATOL``."""
    for rid, b in want.items():
        a = got[rid]
        if a == b:
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        margin, runner_up = margins[rid][i - TRACE[rid][0]]
        assert runner_up == b[i] and margin < GRIFFIN_TIE_ATOL, \
            (what, rid, i, margin, runner_up, b[i])


@pytest.mark.parametrize("arch,blk", SERVED)
def test_engine_streams_match_reference(refs, arch, blk):
    want = refs[arch][0]["serving"][blk]
    eng, streams = _serve(refs, arch, blk)
    if arch == "recurrentgemma-9b":
        _assert_equal_up_to_near_ties(streams, want["streams"],
                                      _RUNS[(arch, blk)][2].margins, arch)
    else:
        assert streams == want["streams"]
    assert dict(eng.counters) == want["counters"]
    # every prompt but its last token went through one decode step
    assert eng.counters["teacher_forced_tokens"] == sum(
        n - 1 for n, _, _ in TRACE.values())
    assert eng.counters["prefill_calls"] == 0
    assert not eng._fast_prefill and not want["fast_prefill"]
    assert eng.fused == want["fused"] is True
    assert eng.weight_quant_trace_count() == want["weight_quant"] == 0
    assert eng.act_quant_trace_count() == want["act_quant"] == 0


def test_vlm_streams_invariant_to_decode_block(refs):
    assert _serve(refs, "internvl2-1b", 1)[1] == \
        _serve(refs, "internvl2-1b", 4)[1]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_engine_replays_the_decode_programs_of_a_family(refs, arch):
    """On the CPU each program is the eager call; the replay check holds
    the programs a family has (no prefill wave; no decode block for the
    recurrent families) and restores the decode state."""
    from repro_torch.serving import graphs
    eng, _ = _serve(refs, arch, 1)
    before = graphs.clone_tree(eng.caches)
    checks = eng._check_replays(False)
    blocked = {"block_decode[n=1]"} if arch == "internvl2-1b" else set()
    assert set(checks) == {"decode_step", "select"} | blocked
    assert all(v == [] for v in checks.values()), checks
    assert eng._prefill_chunk_fn is None
    for (_, a), (_, b) in zip(graphs.leaves(before),
                              graphs.leaves(eng.caches)):
        assert graphs.same_bits(a, b)
    assert "prefill_chunk" not in eng.metrics()["graphs"]["programs"]


# ------------------------------------------------ the engine's family rules
# (mirrors of tests/test_serving.py, on the port's own seeded weights)

def _requests(cfg, lengths, max_new):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n,
                                               dtype=np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lengths, max_new))]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batched_rejected_for_recurrent_families(arch):
    """Mirror of ``test_batched_rejected_for_recurrent_families``: the
    fast path is refused for every family but lm, and ``"auto"`` falls
    back to teacher forcing and still serves."""
    cfg = _cfg(arch)
    api = registry.build(cfg)
    params = registry.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="not eligible"):
        ServingEngine(cfg, api, params, config=EngineConfig(
            batch_slots=2, cache_len=16, prefill="batched"), device="cpu")
    eng = ServingEngine(cfg, api, params, config=EngineConfig(
        batch_slots=2, cache_len=16), device="cpu")
    assert not eng._fast_prefill
    eng.submit(Request(rid=0, prompt=np.asarray([3, 1, 4], np.int32),
                       max_new_tokens=2))
    eng.run_until_drained()
    assert eng.completed[0].new_tokens == 2
    assert eng.counters["teacher_forced_tokens"] == 2


def test_blocked_equals_per_token_vlm():
    """Mirror of ``test_blocked_equals_per_token_vlm``: vlm's
    position-tagged caches make masked pad writes causally invisible."""
    cfg = _cfg("internvl2-1b")
    api = registry.build(cfg)
    params = registry.init_params(cfg, device="cpu")

    def run(blk):
        eng = ServingEngine(cfg, api, params, config=EngineConfig(
            batch_slots=2, cache_len=32, decode_block=blk), device="cpu")
        reqs = _requests(cfg, [5, 7, 3, 4], [4, 2, 5, 3])
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return {r.rid: list(r.tokens) for r in reqs}

    assert run(1) == run(4)


@pytest.mark.parametrize("arch", ("rwkv6-1.6b", "recurrentgemma-9b"))
def test_blocked_rejected_for_recurrent_families(arch):
    """Mirror of ``test_blocked_rejected_for_recurrent_families``."""
    cfg = _cfg(arch)
    api = registry.build(cfg)
    params = registry.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="not eligible"):
        ServingEngine(cfg, api, params, config=EngineConfig(
            batch_slots=2, cache_len=16, decode_block=4), device="cpu")
    with pytest.raises(ValueError, match="not eligible"):
        registry.make_block_decode(api, 4)


def test_pad_token_folds_into_other_slots_recurrent_state():
    """Teacher forcing feeds every other slot token 0 at its own
    position, as the reference does: a KV cache overwrites the pad at
    that slot's next write, but rwkv's state keeps it, so admitting a
    second request moves a decoding slot's state (a difference inside
    the reference that the port keeps)."""
    cfg = _cfg("rwkv6-1.6b")
    api = registry.build(cfg)
    params = registry.init_params(cfg, device="cpu")

    def state_after(second):
        eng = ServingEngine(cfg, api, params, config=EngineConfig(
            batch_slots=2, cache_len=16), device="cpu")
        eng.submit(Request(rid=0, prompt=np.asarray([5, 6], np.int32),
                           max_new_tokens=4))
        eng.step()
        if second:
            eng.submit(Request(rid=1, prompt=np.asarray([7, 8, 9],
                                                        np.int32),
                               max_new_tokens=1))
            eng._admit()
        return eng.caches.s[:, 0].clone()

    assert not torch.equal(state_after(False), state_after(True))
