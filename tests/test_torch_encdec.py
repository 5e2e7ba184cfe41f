"""The encdec family (seamless-m4t-medium) against the JAX reference, on
the CPU.

Reduced seamless-m4t-medium (2 encoder and 2 decoder layers of 64,
frontend 16) with the reference's converted weights, under ``bf16``,
``int8_serving`` and ``int4_serving`` (both packages given the
reference's jitted calibrated scales), with both executor variants:

* ``encode``'s output, prefill logits and the decode state ``(caches,
  enc_out)``;
* four greedy decode steps, from the port's own prefill state fed its
  own argmax tokens, and from the reference's prefill state (converted)
  fed the reference's tokens: logits, greedy tokens (equal) and the
  final state;
* the config, the init tree and a fresh cache (real tensors, one per
  layer); ``projection_paths`` for every leaf; the random calibration
  path against the reference's computed op by op, and the ``prompts=``
  path's KeyError (no frames), as the reference's; the converter's
  round trip of parameters and state; the port's mirror of
  ``tests/test_models_smoke.py::test_prefill_decode_consistency``;
  the engine's refusal beside the reference engine's failure.

Tolerances are the lm family's (``tests/_torch_parity.py``): logits
within 1e-5 absolute (the largest difference seen is 4.8e-7, f32
summation order), bf16 K/V caches and ``enc_out`` within one bf16 ulp
(``_torch_parity.assert_state``), position tags exact, greedy tokens
equal. One reference subprocess
(``_torch_parity.reference("encdec", ...)``).
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
from repro_torch.layers.attention import KVCache
from repro_torch.layers.mplinear import executor_variant
from repro_torch.models import encdec, registry
from repro_torch.quant.calibrate import calibrate_act_scales
from repro_torch.quant.prepare import iter_projection_weights
from repro_torch.serving.engine import ServingEngine

from _jax_reference import (ENCDEC_ARCH, ENCDEC_DECODE_STEPS,
                            FAMILY_POLICIES, calib_batch, calib_prompts,
                            encdec_inputs)
from _torch_parity import one_intra_op_thread  # noqa: F401 (autouse)
from _torch_parity import BF16_RTOL, assert_state, flat, reference

LOGIT_ATOL = 1e-5
VARIANTS = (None, "fused")
PROMPT = 12


@pytest.fixture(scope="module")
def ref():
    out = reference("encdec", ENCDEC_ARCH)
    return out, params_from_numpy(out["params"], device="cpu")


def _cfg(policy="bf16"):
    return dataclasses.replace(reduced(ENCDEC_ARCH), precision_policy=policy)


def _batch():
    return {k: torch.from_numpy(v)
            for k, v in encdec_inputs(reduced(ENCDEC_ARCH)).items()}


def _prepared(ref, policy):
    out, params = ref
    cfg = _cfg(policy)
    api = registry.build(cfg)
    return cfg, api, api.prepare(params, get_policy(policy),
                                 act_scales=out["scales"][policy])


def test_config_equals_the_reference():
    assert dataclasses.asdict(get_config(ENCDEC_ARCH)) == dataclasses.asdict(
        ref_get_config(ENCDEC_ARCH))
    assert dataclasses.asdict(reduced(ENCDEC_ARCH)) == dataclasses.asdict(
        ref_reduced(ENCDEC_ARCH))


def test_init_keeps_the_reference_tree(ref):
    """Paths, shapes and dtypes of ``init`` equal the reference's:
    stacked ``enc_blocks``/``dec_blocks``, ``frontend_proj`` with bias,
    an untied ``lm_head``."""
    mine = flat(to_numpy(registry.init_params(reduced(ENCDEC_ARCH), seed=1,
                                               device="cpu")))
    theirs = flat(ref[0]["params"])
    assert mine.keys() == theirs.keys()
    for k, v in theirs.items():
        assert (mine[k].shape, mine[k].dtype) == (v.shape, v.dtype), k
    assert "frontend_proj/b" in mine and "lm_head/w" in mine


def test_init_cache_allocates_one_tensor_per_layer(ref):
    """A fresh cache has the reference's shapes and values (zeros, empty
    position tags), and owns its memory: an in-place write into one
    layer's cache touches no other layer."""
    want = ref[0]["cases"][("bf16", None)]["prefill_state"][0]
    cache = registry.build(_cfg()).init_cache(2, 16, "cpu")
    assert isinstance(cache, KVCache)
    for t, w, fill in zip(cache, want, (0, 0, -1)):
        assert t.shape == np.asarray(w).shape
        assert 0 not in t.stride()
        assert bool((t == fill).all())
    assert len({t.data_ptr() for t in cache}) == 3
    cache.k[0].fill_(1)
    assert bool((cache.k[1] == 0).all())


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("policy", FAMILY_POLICIES)
def test_encode_matches_reference(ref, policy, variant):
    case = ref[0]["cases"][(policy, variant)]
    cfg, _, prepared = _prepared(ref, policy)
    with executor_variant(variant), torch.no_grad():
        enc = encdec.encode(prepared, cfg, _batch()["frames"])
    assert enc.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(enc), case["encode"],
                               rtol=BF16_RTOL, atol=0)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("policy", FAMILY_POLICIES)
def test_prefill_matches_reference(ref, policy, variant):
    """Prefill logits, and the decode state it returns: the decoder's
    K/V/pos caches and the encoder output."""
    case = ref[0]["cases"][(policy, variant)]
    _, api, prepared = _prepared(ref, policy)
    caches = api.init_cache(2, 16, "cpu")
    with executor_variant(variant), torch.no_grad():
        logits, state = api.prefill(prepared, _batch(), caches)
    np.testing.assert_allclose(logits.numpy(), case["prefill_logits"],
                               rtol=0, atol=LOGIT_ATOL)
    assert state[0] is caches
    assert_state(state, case["prefill_state"], "prefill")


@pytest.mark.parametrize("start", ("own", "reference"))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("policy", FAMILY_POLICIES)
def test_greedy_decode_matches_reference(ref, policy, variant, start):
    """Four greedy decode steps: from the port's own prefill state fed
    its own argmax tokens, or from the reference's prefill state
    (converted) fed the reference's; logits, tokens and the final state
    (the caches written in place)."""
    case = ref[0]["cases"][(policy, variant)]
    _, api, prepared = _prepared(ref, policy)
    with executor_variant(variant), torch.no_grad():
        if start == "own":
            logits, state = api.prefill(prepared, _batch(),
                                        api.init_cache(2, 16, "cpu"))
            tok = logits.argmax(-1).to(torch.int32)[:, None]
        else:
            state = params_from_numpy(case["prefill_state"], device="cpu")
            tok = torch.from_numpy(np.argmax(case["prefill_logits"], -1)
                                   .astype(np.int32)[:, None])
        assert torch.equal(tok[:, 0], torch.from_numpy(
            np.argmax(case["prefill_logits"], -1).astype(np.int32)))
        ptrs = [t.data_ptr() for t in flat(state).values()]
        pos = torch.full((2,), PROMPT, dtype=torch.int32)
        steps = list(zip(case["decode_logits"], case["decode_tokens"]))
        assert len(steps) == ENCDEC_DECODE_STEPS
        for want, want_tok in steps:
            logits, state = api.decode_step(prepared,
                                            {"token": tok, "pos": pos}, state)
            assert [t.data_ptr() for t in flat(state).values()] == ptrs
            np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                                       atol=LOGIT_ATOL)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            np.testing.assert_array_equal(tok[:, 0].numpy(), want_tok)
            pos = pos + 1
    assert_state(state, case["decode_state"], "decode")


def test_projection_paths_equal_the_reference():
    """Every container of the init tree resolves to the reference's
    policy path (None for embeddings, norms and the untied head)."""
    from repro.models import registry as ref_registry
    cfg = reduced(ENCDEC_ARCH)
    mine = registry.projection_paths(cfg)
    theirs = ref_registry.projection_paths(ref_reduced(ENCDEC_ARCH))
    containers = {p.rsplit("/", 1)[0] for p in flat(to_numpy(
        registry.init_params(cfg, device="cpu")))}
    assert len(containers) > 20
    for p in sorted(containers):
        assert mine(p) == theirs(p), p
    resolved = {mine(p) for p in containers} - {None}
    assert resolved == {"frontend_proj"} | {
        f"{s}/{m}" for s, ms in (("enc/attn", "wq wk wv wo"),
                                 ("enc/mlp", "w_gate w_up w_down"),
                                 ("dec/attn", "wq wk wv wo"),
                                 ("dec/xattn", "wq wk wv wo"),
                                 ("dec/mlp", "w_gate w_up w_down"))
        for m in ms.split()}
    assert mine("lm_head") is None and mine("embed") is None
    assert not registry.block_decode_eligible(cfg)


def test_calibration_batch_is_the_reference_batch():
    cfg = reduced(ENCDEC_ARCH)
    for seed in (0, 1):
        got = registry.calibration_batch(cfg, 2, 16, seed=seed)
        want = calib_batch(cfg, 2, 16, seed)
        assert got.keys() == want.keys() == {"tokens", "frames"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert got["frames"].shape == (2, 4, cfg.frontend_dim)


@pytest.mark.parametrize("policy", ("int8_serving", "int4_serving"))
def test_calibrated_scales_match_reference(ref, policy):
    """The random calibration path (two numpy batches of 2 x 16 tokens
    and 4 frames) gives the reference's scales computed op by op, on
    every projection path, ``frontend_proj`` included."""
    out, params = ref
    cfg = _cfg(policy)
    api = registry.build(cfg)
    got = calibrate_act_scales(cfg, api, params, device="cpu")
    assert got == out["eager_scales"][policy]
    paths = registry.projection_paths(cfg)
    assert set(got) == {paths(p) for p, _ in
                        iter_projection_weights(params, paths)}


def test_calibration_on_prompts_raises_as_the_reference():
    """With prompts, calibration passes no frames: encdec's prefill
    raises KeyError, in the reference too (as vlm's without patches)."""
    import jax

    from repro.models import registry as ref_registry
    from repro.quant.calibrate import calibrate_act_scales as ref_calibrate
    cfg = _cfg("int8_serving")
    with pytest.raises(KeyError, match="frames"):
        calibrate_act_scales(cfg, registry.build(cfg),
                             registry.init_params(cfg, device="cpu"),
                             prompts=calib_prompts(), device="cpu")
    rcfg = dataclasses.replace(ref_reduced(ENCDEC_ARCH),
                               precision_policy="int8_serving")
    rapi = ref_registry.build(rcfg)
    with pytest.raises(KeyError, match="frames"):
        ref_calibrate(rcfg, rapi, rapi.init(jax.random.PRNGKey(0)),
                      prompts=calib_prompts())


def test_convert_round_trip_of_params_and_state(ref):
    """Parameters cross to numpy and back bit for bit. The reference's
    decode state ``(KVCache, enc_out)`` converts into the port's
    ``(KVCache, tensor)`` with its dtypes, and ``to_numpy`` gives back
    the reference's arrays bit for bit (``to_numpy`` turns a KVCache
    into the tuple of its fields)."""
    out, params = ref
    back = params_from_numpy(to_numpy(params), device="cpu")
    for (p, a), (q, b) in zip(flat(params).items(), flat(back).items()):
        assert p == q and torch.equal(a, b), p
    want = out["cases"][("int8_serving", None)]["decode_state"]
    state = params_from_numpy(want, device="cpu")
    assert isinstance(state, tuple) and len(state) == 2
    assert isinstance(state[0], KVCache)
    assert state[0].k.dtype == state[1].dtype == torch.bfloat16
    assert state[0].pos.dtype == torch.int32
    mine, theirs = flat(to_numpy(state)), flat(want)
    assert len(mine) == len(theirs) == 4
    for a, b in zip(mine.values(), theirs.values()):
        np.testing.assert_array_equal(a, np.asarray(b, a.dtype))


def test_prefill_decode_consistency():
    """Mirror of ``tests/test_models_smoke.py::test_prefill_decode_consistency``
    for encdec: at f32 compute, a decode step after a prefill of S
    tokens gives the last logits of a prefill of S + 1."""
    cfg = dataclasses.replace(reduced(ENCDEC_ARCH), compute_dtype="float32")
    api = registry.build(cfg)
    params = api.init(1, "cpu")
    b, s = 2, 16
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + 1),
                                           dtype=np.int32))
    frames = torch.from_numpy(rng.standard_normal(
        (b, 8, cfg.frontend_dim), dtype=np.float32))
    with torch.no_grad():
        _, state = api.prefill(params, {"tokens": tokens[:, :s],
                                        "frames": frames},
                               api.init_cache(b, s + 1, "cpu"))
        logits_b, _ = api.decode_step(
            params, {"token": tokens[:, s:s + 1],
                     "pos": torch.full((b,), s, dtype=torch.int32)}, state)
        logits_c, _ = api.prefill(params, {"tokens": tokens,
                                           "frames": frames},
                                  api.init_cache(b, s + 1, "cpu"))
    assert logits_b.shape == (b, cfg.padded_vocab)
    np.testing.assert_allclose(logits_b.numpy(), logits_c.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_engine_refuses_encdec_as_the_reference_fails():
    """The port's engine refuses encdec at construction, naming the
    family; the reference's engine is built but fails with a ValueError
    at its first decode (its decode state exists only after a prefill
    with frames)."""
    import jax

    from repro.models import registry as ref_registry
    from repro.serving.engine import Request as RefRequest
    from repro.serving.engine import ServingEngine as RefEngine
    cfg = _cfg()
    with pytest.raises(ValueError, match="encdec"):
        ServingEngine(cfg, registry.build(cfg),
                      registry.init_params(cfg, device="cpu"), device="cpu")
    rcfg = ref_reduced(ENCDEC_ARCH)
    rapi = ref_registry.build(rcfg)
    eng = RefEngine(rcfg, rapi, rapi.init(jax.random.PRNGKey(0)))
    eng.submit(RefRequest(rid=0, prompt=np.asarray([3, 1, 4], np.int32),
                          max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.run_until_drained()
