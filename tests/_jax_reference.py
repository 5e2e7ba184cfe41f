"""The JAX reference's outputs for the torch parity tests.

Run as ``python tests/_jax_reference.py <task> <out.pkl> [<arch>]`` by
``_torch_parity.reference``, in a subprocess whose ``XLA_FLAGS`` carry
``--xla_allow_excess_precision=false``. XLA's default lets a fused
computation skip the bf16 roundings the reference's code asks for
(``astype(bfloat16)`` inside a scanned block keeps f32 precision); with
the flag off both packages round exactly where the source says, and
their logits agree to float32 rounding. The flag is process-wide and is
read once, when JAX starts its backend, so it cannot be set inside the
test process without changing every other JAX test there.

Each task returns plain dicts of numpy arrays and Python values; the
caller reads them back with pickle (a file this script just wrote). The
optional ``<arch>`` sets ``ARCH`` (qwen2-0.5b by default) for the task:
``arch`` computes everything ``tests/test_torch_archs.py`` compares for
one architecture in one process, and ``family`` everything
``tests/test_torch_families.py`` compares for one of the vlm, rwkv and
griffin architectures, and ``encdec`` what ``tests/test_torch_encdec.py``
compares for seamless-m4t-medium.
"""
import dataclasses
import os
import pickle
import sys

import numpy as np

ARCH = "qwen2-0.5b"
LM_POLICIES = ("bf16", "int8_serving", "int4_serving", "fidelity_int8",
               "fidelity_fp16_ipu")
# the policies with int routes, whose act scales are calibrated
CALIBRATED = ("int8_serving", "int4_serving", "fidelity_int8")


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def calib_prompts():
    rng = np.random.default_rng(100)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (9, 14, 6)]


def lm_inputs():
    rng = np.random.default_rng(0)
    return {"prefill_tokens": rng.integers(0, 512, (2, 12)).astype(np.int32),
            "chunk_tokens": rng.integers(0, 512, (3, 5)).astype(np.int32),
            "chunk_offsets": np.array([0, 3, 7], np.int32),
            "chunk_lengths": np.array([5, 2, 0], np.int32)}


def task_lm():
    """Per policy and executor variant: prefill logits and caches, then a
    chunked prefill into a live cache and three greedy decode steps."""
    import jax

    from repro.configs import reduced
    from repro.models import registry

    os.environ["REPRO_FUSED_BACKEND"] = "xla"
    base = reduced(ARCH)
    params = registry.build(base).init(jax.random.PRNGKey(0))
    out = {"params": _np_tree(params), "cases": {}, "eager_scales": {}}
    _lm_cases(base, params, LM_POLICIES, out)
    return out


def _lm_cases(base, params, policies, out):
    """``task_lm``'s cases for ``policies`` into ``out``."""
    import jax
    import jax.numpy as jnp

    from repro.core.policy import get_policy
    from repro.layers.mplinear import executor_variant
    from repro.models import registry
    from repro.quant.calibrate import calibrate_act_scales

    inp = lm_inputs()
    for pol in policies:
        cfg = dataclasses.replace(base, precision_policy=pol)
        api = registry.build(cfg)
        scales = None
        if pol in CALIBRATED:
            scales = calibrate_act_scales(cfg, api, params,
                                          prompts=calib_prompts())
        if pol in CALIBRATED and get_policy(pol).default.exact:
            # the same calibration op by op: XLA's fusion of the
            # dynamic per-row act quantize can flip a rounding that
            # the op-by-op program (and the port) does not
            with jax.disable_jit():
                out["eager_scales"][pol] = calibrate_act_scales(
                    cfg, api, params, prompts=calib_prompts())
        prepared = api.prepare(params, get_policy(pol), act_scales=scales)
        for variant in (None, "fused"):
            with executor_variant(variant):
                logits, caches = api.prefill(
                    prepared, {"tokens": jnp.asarray(inp["prefill_tokens"])},
                    api.init_cache(2, 16))
                c2 = api.init_cache(3, 8)
                c2 = api.prefill_chunk(
                    prepared, {"tokens": jnp.asarray(inp["chunk_tokens"]),
                               "offsets": jnp.asarray(inp["chunk_offsets"]),
                               "lengths": jnp.asarray(inp["chunk_lengths"])},
                    c2)
                chunk_caches = _np_tree(c2)
                tok = jnp.asarray(inp["chunk_tokens"][:, :1])
                pos = jnp.asarray(inp["chunk_offsets"]
                                  + inp["chunk_lengths"])
                steps = []
                for _ in range(3):
                    lg, c2 = api.decode_step(prepared,
                                             {"token": tok, "pos": pos}, c2)
                    steps.append(np.asarray(lg))
                    tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
                    pos = pos + 1
            out["cases"][(pol, variant)] = {
                "scales": scales, "prefill_logits": np.asarray(logits),
                "prefill_caches": _np_tree(caches),
                "chunk_caches": chunk_caches, "decode_logits": steps,
                "decode_caches": _np_tree(c2)}


# rid -> (prompt_len, budget, submit_tick): a multi-wave long prompt,
# staggered arrivals that land mid-decode, one oversized request
TRACE = {0: (18, 7, 0), 1: (5, 10, 0), 2: (7, 11, 2), 3: (4, 6, 3),
         4: (10, 60, 5)}


def trace_prompts():
    rng = np.random.default_rng(1)
    return {rid: rng.integers(0, 512, n).astype(np.int32)
            for rid, (n, _, _) in sorted(TRACE.items())}


def drive_trace(make_engine, make_request, stops):
    """Submit each trace request at its tick and step until drained;
    returns (engine, {rid: tokens})."""
    prompts = trace_prompts()
    eng = make_engine()
    pending = {rid: t for rid, (_, _, t) in TRACE.items()}
    tick = 0
    while pending or eng.has_pending():
        for rid in [r for r, t in pending.items() if t <= tick]:
            del pending[rid]
            eng.submit(make_request(rid, prompts[rid], TRACE[rid][1],
                                    stops.get(rid, ())))
        eng.step()
        tick += 1
        if tick > 10_000:
            raise RuntimeError("trace did not drain")
    return eng, {r.rid: list(r.tokens) for r in eng.completed.values()}


ENGINE_CASES = {
    # name: (policy, EngineConfig overrides)
    "int8_b1": ("int8_serving", dict(decode_block=1)),
    "int8_b2": ("int8_serving", dict(decode_block=2)),
    "int8_b3": ("int8_serving", dict(decode_block=3)),
    "int8_b8": ("int8_serving", dict(decode_block=8)),
    "fid_on": ("fidelity_int8", dict(decode_block=4, fused_executors="on")),
    "fid_off": ("fidelity_int8", dict(decode_block=4,
                                      fused_executors="off")),
    "int4_off_b4": ("int4_serving", dict(decode_block=4,
                                         fused_executors="off")),
    "fp16_ipu_b4": ("fidelity_fp16_ipu", dict(decode_block=4)),
    # admission by teacher forcing on the lm family
    "int8_teacher": ("int8_serving", dict(decode_block=1,
                                          prefill="teacher")),
}
# stop ids taken from the greedy streams, so that EOS stopping fires
# mid-stream (and mid-block) under every policy the cases serve
STOPS = {1: (240, 222), 3: (424,)}


def task_serving():
    """The bursty trace through the reference engine under each case,
    with the counters the parity tests compare."""
    import jax

    from repro.configs import reduced
    from repro.models import registry
    from repro.quant.calibrate import calibrate_act_scales
    from repro.serving import EngineConfig, Request, SamplingParams
    from repro.serving.engine import ServingEngine

    os.environ["REPRO_FUSED_BACKEND"] = "xla"
    base = reduced(ARCH)
    params = registry.build(base).init(jax.random.PRNGKey(0))
    out = {"params": _np_tree(params), "scales": {}, "cases": {}}
    for name, (pol, kw) in ENGINE_CASES.items():
        cfg = dataclasses.replace(base, precision_policy=pol)
        api = registry.build(cfg)
        if pol not in out["scales"]:
            out["scales"][pol] = calibrate_act_scales(
                cfg, api, params, prompts=calib_prompts()) \
                if pol in CALIBRATED else None
        config = EngineConfig(batch_slots=2, cache_len=64, prefill_chunk=4,
                              act_calibration=out["scales"][pol], **kw)

        def make_request(rid, prompt, budget, stops):
            return Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                           sampling=SamplingParams(stop_ids=stops))

        eng, streams = drive_trace(
            lambda: ServingEngine(cfg, api, params, config=config),
            make_request, STOPS)
        out["cases"][name] = {
            "streams": streams,
            "counters": dict(eng.counters),
            "truncated": {r.rid: r.truncated
                          for r in eng.completed.values()},
            "finish": {r.rid: r.finish_reason
                       for r in eng.completed.values()},
            "weight_quant": eng.weight_quant_trace_count(),
            "act_quant": eng.act_quant_trace_count(),
            "staged": eng.staged_trace_count(),
            "fused": eng.fused}
    return out


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN = os.path.join(REPO, "results", "plans", "qwen2_0_5b.json")
# an fp plan (fp8 with per-group scales, fp4) and an fp/per-group policy
# for checkpoints: rules as (group name, mode, group_size)
FP_PLAN_RULES = (("attn_qkv", "fp8", 8), ("ffn_in", "fp4", None))
FP_GROUPED_RULES = (("attn_qkv", "fp4", 16), ("ffn_in", "fp8", 32),
                    ("ffn_out", "int4", 32))
PLAN_CONFIG = dict(batch_slots=2, cache_len=64, prefill_chunk=4,
                   decode_block=2, act_calibration="auto")


def fp_plan_json(groups):
    """The fp plan as ``precision-plan-v1`` JSON; ``groups`` maps a
    projection-group name to its pattern."""
    return {"schema": "precision-plan-v1", "name": "fp_tier",
            "arch": ARCH, "default_mode": "bf16",
            "rules": [{"group": g, "pattern": groups[g], "mode": mode,
                       "group_size": gs}
                      for g, mode, gs in FP_PLAN_RULES]}


def fp_grouped_rules(groups):
    """(pattern, mode, group_size) of the ``fp_grouped`` policy."""
    return [(groups[g], mode, gs) for g, mode, gs in FP_GROUPED_RULES]


def _greedy_request(rid, prompt, budget, stops):
    from repro.serving import Request, SamplingParams
    return Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                   sampling=SamplingParams(stop_ids=stops))


def task_plan():
    """The committed plan and an fp plan served by the reference engine
    over the trace (``act_calibration="auto"``): routing of one decode
    step, the act scales taken, streams and counters."""
    import json
    import tempfile

    import jax

    from repro.configs import reduced
    from repro.models import registry
    from repro.serving import EngineConfig
    from repro.serving.engine import ServingEngine

    os.environ["REPRO_FUSED_BACKEND"] = "xla"
    base = reduced(ARCH)
    params = registry.build(base).init(jax.random.PRNGKey(0))
    groups = {g.name: g.pattern for g in registry.projection_groups(base)}
    out = {"params": _np_tree(params), "cases": {}}
    with tempfile.TemporaryDirectory() as d:
        fp_path = os.path.join(d, "fp_plan.json")
        with open(fp_path, "w") as f:
            json.dump(fp_plan_json(groups), f)
        for name, path in (("committed", PLAN), ("fp", fp_path)):
            cfg = dataclasses.replace(base, precision_policy=f"plan:{path}")
            api = registry.build(cfg)
            config = EngineConfig(**PLAN_CONFIG)
            eng, streams = drive_trace(
                lambda: ServingEngine(cfg, api, params, config=config),
                _greedy_request, {})
            out["cases"][name] = {
                "routes": eng.routing_report(), "streams": streams,
                "scales": eng.act_scales, "fused": eng.fused,
                "counters": dict(eng.counters),
                "weight_bytes": eng.weight_bytes()}
    return out


def _dir_bytes(path):
    """{file name: bytes} of a checkpoint step directory."""
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


def task_checkpoint():
    """Reference engine checkpoints (``int4_serving`` calibrated, and an
    fp/per-group policy), as the bytes of their step directories, with
    the saved engine's leaves and its streams over the trace."""
    import tempfile

    import jax

    from repro.configs import reduced
    from repro.core.policy import (PrecisionPolicy, PrecisionSpec,
                                   register_policy)
    from repro.fabric.checkpoint import save_engine_checkpoint
    from repro.models import registry
    from repro.serving import EngineConfig
    from repro.serving.engine import ServingEngine

    os.environ["REPRO_FUSED_BACKEND"] = "xla"
    base = reduced(ARCH)
    params = registry.build(base).init(jax.random.PRNGKey(0))
    out = {"cases": {}}
    cases = (("int4_serving", dict(act_calibration="auto",
                                   cost_correction="online")),)
    if ARCH == "qwen2-0.5b":         # fp_grouped names dense groups
        groups = {g.name: g.pattern
                  for g in registry.projection_groups(base)}
        register_policy(PrecisionPolicy("fp_grouped", rules=tuple(
            (pat, PrecisionSpec(mode, group_size=gs))
            for pat, mode, gs in fp_grouped_rules(groups))))
        cases += (("fp_grouped", dict(act_calibration="auto")),)
    for policy, kw in cases:
        cfg = dataclasses.replace(base, precision_policy=policy)
        api = registry.build(cfg)
        config = EngineConfig(batch_slots=2, cache_len=64, prefill_chunk=4,
                              decode_block=2, **kw)
        eng = ServingEngine(cfg, api, params, config=config)
        with tempfile.TemporaryDirectory() as d:
            step_dir = save_engine_checkpoint(eng, d, step=3)
            files = _dir_bytes(step_dir)
        leaves = jax.tree_util.tree_leaves(eng.params)
        _, streams = drive_trace(lambda: eng, _greedy_request, {})
        out["cases"][policy] = {
            "files": files, "streams": streams, "fused": eng.fused,
            "leaves": [np.asarray(x) for x in leaves],
            "scales": eng.act_scales}
    return out


def task_rebuild():
    """The reference's ``build_engine`` over the engine checkpoint in
    ``$REPRO_PARITY_CHECKPOINT`` (written by the port): the weight
    quantizations it made, its leaves and its streams over the trace."""
    import jax

    from repro.fabric.checkpoint import build_engine
    from repro.layers.mplinear import count_weight_quant

    os.environ["REPRO_FUSED_BACKEND"] = "xla"
    with count_weight_quant() as wq:
        eng = build_engine(os.environ["REPRO_PARITY_CHECKPOINT"])
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(eng.params)]
    _, streams = drive_trace(lambda: eng, _greedy_request, {})
    return {"weight_quant": wq[0], "leaves": leaves, "streams": streams,
            "fused": eng.fused, "scales": eng.act_scales}


ROUTER_POLICIES = (f"plan:{PLAN}", "bf16", "int4_serving")
ROUTER_STRATEGIES = ("plan_aware", "least_loaded", "round_robin")


def router_requests():
    """A fixed sequence: 10 prompts, every third tagged 'accuracy'."""
    rng = np.random.default_rng(5)
    return [(i, rng.integers(0, 512, 3 + (7 * i) % 9).astype(np.int32),
             2 + i % 3, ("accuracy",) if i % 3 == 0 else ())
            for i in range(10)]


def drive_router(router, make_request):
    """Submit the fixed sequence, stepping the router after every second
    submission; returns (replica name per request, {rid: tokens})."""
    chosen = []
    for rid, prompt, budget, tags in router_requests():
        chosen.append(router.submit(make_request(rid, prompt, budget,
                                                 tags)).name)
        if rid % 2:
            router.step()
    router.run_until_drained()
    streams = {rid: list(r.tokens) for rid, r in router.completed.items()}
    return chosen, streams


def task_router():
    """Three replicas (the committed plan, bf16, int4_serving) built by
    the reference's ``build_replicas``: their static costs, then the
    fixed request sequence under each strategy on a fresh fleet."""
    import jax

    from repro.configs import reduced
    from repro.models import registry
    from repro.serving import EngineConfig, Request
    from repro.serving.router import Router, build_replicas

    os.environ["REPRO_FUSED_BACKEND"] = "xla"
    base = reduced(ARCH)
    params = registry.build(base).init(jax.random.PRNGKey(0))
    config = EngineConfig(batch_slots=2, cache_len=64, prefill_chunk=4)
    out = {"params": _np_tree(params), "strategies": {}}

    def make_request(rid, prompt, budget, tags):
        return Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                       tags=tags)

    for strategy in ROUTER_STRATEGIES:
        reps = build_replicas(base, ROUTER_POLICIES, params=params,
                              config=config)
        out["costs"] = {r.name: dict(r.cost) for r in reps}
        router = Router(reps, strategy=strategy)
        chosen, streams = drive_router(router, make_request)
        out["strategies"][strategy] = {
            "chosen": chosen, "streams": streams,
            "counters": router.routing_counters()}
    return out


# the lm family's other configurations (``tests/test_torch_archs.py``)
ARCHS = ("gemma2-9b", "glm4-9b", "stablelm-12b", "mixtral-8x7b",
         "qwen3-moe-30b-a3b")
ARCH_POLICIES = ("bf16", "int8_serving", "int4_serving")
# the archs whose engine streams are compared, and the decode blocks
SERVED_ARCHS = ("mixtral-8x7b", "qwen3-moe-30b-a3b", "gemma2-9b")
SERVED_BLOCKS = (1, 4)


def task_arch():
    """For ``ARCH``: ``task_lm``'s cases under ``ARCH_POLICIES``, and for
    a served arch the trace through the reference engine under
    ``int4_serving`` (the calibrated scales, fused) per decode block."""
    import jax

    from repro.configs import reduced
    from repro.models import registry
    from repro.serving import EngineConfig
    from repro.serving.engine import ServingEngine

    os.environ["REPRO_FUSED_BACKEND"] = "xla"
    base = reduced(ARCH)
    params = registry.build(base).init(jax.random.PRNGKey(0))
    out = {"params": _np_tree(params), "cases": {}, "eager_scales": {},
           "serving": {}}
    _lm_cases(base, params, ARCH_POLICIES, out)
    # the calibration op by op too: under jit XLA may rewrite a norm's
    # f32 arithmetic (stablelm's LayerNorm), and a last-ulp change can
    # flip the bf16 rounding of a projection's largest input
    from repro.quant.calibrate import calibrate_act_scales
    for pol in ARCH_POLICIES:
        if pol in CALIBRATED:
            cfg = dataclasses.replace(base, precision_policy=pol)
            with jax.disable_jit():
                out["eager_scales"][pol] = calibrate_act_scales(
                    cfg, registry.build(cfg), params,
                    prompts=calib_prompts())
    if ARCH in SERVED_ARCHS:
        cfg = dataclasses.replace(base, precision_policy="int4_serving")
        api = registry.build(cfg)
        scales = out["cases"][("int4_serving", None)]["scales"]
        for blk in SERVED_BLOCKS:
            config = EngineConfig(batch_slots=2, cache_len=64,
                                  prefill_chunk=4, decode_block=blk,
                                  act_calibration=scales)
            eng, streams = drive_trace(
                lambda: ServingEngine(cfg, api, params, config=config),
                _greedy_request, STOPS)
            out["serving"][blk] = {
                "streams": streams, "counters": dict(eng.counters),
                "fused": eng.fused,
                "weight_quant": eng.weight_quant_trace_count(),
                "act_quant": eng.act_quant_trace_count()}
    return out


# the families the engine serves by teacher forcing
# (``tests/test_torch_families.py``), and the decode blocks served
FAMILY_ARCHS = ("internvl2-1b", "rwkv6-1.6b", "recurrentgemma-9b")
FAMILY_POLICIES = ("bf16", "int8_serving", "int4_serving")
FAMILY_BLOCKS = {"internvl2-1b": (1, 4), "rwkv6-1.6b": (1,),
                 "recurrentgemma-9b": (1,)}
FAMILY_DECODE_STEPS = 3


def calib_batch(cfg, batch, seq_len, seed):
    """The port's ``registry.calibration_batch`` in numpy: random tokens
    and, for vlm, standard-normal patches, for encdec frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, min(cfg.vocab, 1000),
                                  (batch, seq_len), dtype=np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.vit_dim), dtype=np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, seq_len // 4, cfg.frontend_dim), dtype=np.float32)
    return out


def family_inputs(cfg):
    """The prefill batch of the forward cases (patches for vlm)."""
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, 512, (2, 12)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (2, cfg.n_patches, cfg.vit_dim)).astype(np.float32)
    return out


def batch_scales(cfg, api, params, n_batches=2, batch=2, seq_len=16,
                 seed=0):
    """``calibrate_act_scales``' random path over ``calib_batch``'s
    numpy batches instead of ``materialize_batch``'s jax.random ones."""
    import jax
    import jax.numpy as jnp

    from repro.layers import mplinear
    from repro.quant.calibrate import scales_from_absmax
    with mplinear.collect_act_stats() as absmax:
        for i in range(n_batches):
            cal = calib_batch(cfg, batch, seq_len, seed + i)
            api.prefill(params, {k: jnp.asarray(v) for k, v in cal.items()},
                        api.init_cache(batch, seq_len))
        jax.effects_barrier()
    return scales_from_absmax(absmax)


def task_family():
    """For ``ARCH`` (vlm, rwkv or griffin) under ``FAMILY_POLICIES``:
    scales calibrated on ``calib_batch`` (jitted and op by op) and, op
    by op, on the prompts; per policy and executor variant, prefill logits and
    state, then greedy decode steps from that state; and the trace
    through the reference engine under ``int4_serving`` (those scales,
    ``prefill="auto"``) per decode block."""
    import jax
    import jax.numpy as jnp

    from repro.configs import reduced
    from repro.core.policy import get_policy
    from repro.layers.mplinear import executor_variant
    from repro.models import registry
    from repro.quant.calibrate import calibrate_act_scales
    from repro.serving import EngineConfig
    from repro.serving.engine import ServingEngine

    os.environ["REPRO_FUSED_BACKEND"] = "xla"
    base = reduced(ARCH)
    params = registry.build(base).init(jax.random.PRNGKey(0))
    out = {"params": _np_tree(params), "cases": {}, "scales": {},
           "eager_scales": {}, "prompt_scales": {}, "serving": {}}
    inp = family_inputs(base)
    n_p = base.n_patches or 0
    for pol in FAMILY_POLICIES:
        cfg = dataclasses.replace(base, precision_policy=pol)
        api = registry.build(cfg)
        scales = None
        if pol in CALIBRATED:
            scales = batch_scales(cfg, api, params)
            with jax.disable_jit():
                out["eager_scales"][pol] = batch_scales(cfg, api, params)
                if cfg.family != "vlm":    # vlm's prefill needs patches
                    out["prompt_scales"][pol] = calibrate_act_scales(
                        cfg, api, params, prompts=calib_prompts())
        out["scales"][pol] = scales
        prepared = api.prepare(params, get_policy(pol), act_scales=scales)
        for variant in (None, "fused"):
            with executor_variant(variant):
                logits, state = api.prefill(
                    prepared, {k: jnp.asarray(v) for k, v in inp.items()},
                    api.init_cache(2, 16))
                prefill_state = _np_tree(state)
                tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
                pos = jnp.full((2,), 12 + n_p, jnp.int32)
                steps = []
                for _ in range(FAMILY_DECODE_STEPS):
                    lg, state = api.decode_step(
                        prepared, {"token": tok, "pos": pos}, state)
                    steps.append(np.asarray(lg))
                    tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
                    pos = pos + 1
            out["cases"][(pol, variant)] = {
                "prefill_logits": np.asarray(logits),
                "prefill_state": prefill_state, "decode_logits": steps,
                "decode_state": _np_tree(state)}
    cfg = dataclasses.replace(base, precision_policy="int4_serving")
    api = registry.build(cfg)
    for blk in FAMILY_BLOCKS[ARCH]:
        config = EngineConfig(batch_slots=2, cache_len=64, prefill_chunk=4,
                              decode_block=blk,
                              act_calibration=out["scales"]["int4_serving"])
        eng, streams = drive_trace(
            lambda: ServingEngine(cfg, api, params, config=config),
            _greedy_request, STOPS)
        out["serving"][blk] = {
            "streams": streams, "counters": dict(eng.counters),
            "fused": eng.fused, "fast_prefill": eng._fast_prefill,
            "weight_quant": eng.weight_quant_trace_count(),
            "act_quant": eng.act_quant_trace_count()}
    return out


ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_DECODE_STEPS = 4


def encdec_inputs(cfg):
    """The prefill batch of the encdec cases: 12 tokens behind 8 frames
    a row."""
    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, 512, (2, 12)).astype(np.int32),
            "frames": rng.standard_normal(
                (2, 8, cfg.frontend_dim)).astype(np.float32)}


def task_encdec():
    """Reduced seamless-m4t-medium under ``FAMILY_POLICIES``: scales
    calibrated on ``calib_batch`` (jitted and op by op); per policy and
    executor variant, ``encode``'s output, prefill logits and decode
    state ``(caches, enc_out)``, then greedy decode steps from that
    state (logits, tokens, final state)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import reduced
    from repro.core.policy import get_policy
    from repro.layers.mplinear import executor_variant
    from repro.models import encdec, registry

    os.environ["REPRO_FUSED_BACKEND"] = "xla"
    base = reduced(ENCDEC_ARCH)
    params = registry.build(base).init(jax.random.PRNGKey(0))
    out = {"params": _np_tree(params), "cases": {}, "scales": {},
           "eager_scales": {}}
    inp = encdec_inputs(base)
    batch = {k: jnp.asarray(v) for k, v in inp.items()}
    for pol in FAMILY_POLICIES:
        cfg = dataclasses.replace(base, precision_policy=pol)
        api = registry.build(cfg)
        scales = None
        if pol in CALIBRATED:
            scales = batch_scales(cfg, api, params)
            with jax.disable_jit():
                out["eager_scales"][pol] = batch_scales(cfg, api, params)
        out["scales"][pol] = scales
        prepared = api.prepare(params, get_policy(pol), act_scales=scales)
        for variant in (None, "fused"):
            with executor_variant(variant):
                enc = encdec.encode(prepared, cfg, batch["frames"])
                logits, state = api.prefill(prepared, batch,
                                            api.init_cache(2, 16))
                prefill_state = _np_tree(state)
                tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
                pos = jnp.full((2,), 12, jnp.int32)
                steps, tokens = [], []
                for _ in range(ENCDEC_DECODE_STEPS):
                    lg, state = api.decode_step(
                        prepared, {"token": tok, "pos": pos}, state)
                    steps.append(np.asarray(lg))
                    tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
                    tokens.append(np.asarray(tok[:, 0]))
                    pos = pos + 1
            out["cases"][(pol, variant)] = {
                "encode": np.asarray(enc),
                "prefill_logits": np.asarray(logits),
                "prefill_state": prefill_state, "decode_logits": steps,
                "decode_tokens": tokens, "decode_state": _np_tree(state)}
    return out


# ------------------------------------------------------------ training
# ``tests/test_torch_train.py`` and ``tests/test_torch_train_families.py``

TRAIN_ARCH = "qwen2-0.5b"
TRAIN_FAMILY_ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b", "mixtral-8x7b",
                      "internvl2-1b", "seamless-m4t-medium")
# the policies whose loss and gradients the qwen2 cases compare; "fp32"
# also runs the activations in f32 (compute_dtype)
TRAIN_POLICIES = ("fp32", "bf16", "int8_serving")
# the whole-step cases: name -> (policy, TrainConfig overrides, batch)
STEP_CASES = {"plain": ("bf16", {}, 2),
              "mb2_scaled": ("bf16", dict(microbatches=2,
                                          use_loss_scaling=True), 4)}
N_STEPS = 3
TRAIN_SEQ = 16
# the fused-xent cases: (S, chunk, masked)
XENT_CASES = ((16, 8, False), (16, 8, True), (13, 8, False), (13, 8, True),
              (13, 512, True))
LOSS_SCALE_FLAGS = (True, True, False, True, True, True, True, False, True)
SCHEDULE_STEPS = (0, 1, 5, 10, 50, 99, 100, 101, 777, 5000, 9999, 10000,
                  20000)


def train_config(policy):
    """The reduced qwen2 config of a training case: ``policy``, and f32
    activations under "fp32"."""
    from repro.configs import reduced
    cfg = reduced(TRAIN_ARCH)
    if policy == "fp32":
        return dataclasses.replace(cfg, precision_policy="fp32",
                                   compute_dtype="float32")
    return dataclasses.replace(cfg, precision_policy=policy)


def step_config(case):
    """The ``TrainConfig`` fields of a whole-step case (lr 1e-3, warmup
    of one step, so every step after the first moves the weights)."""
    return dict(lr=1e-3, warmup=1, total_steps=10, **STEP_CASES[case][1])


def train_tokens(vocab, batch, seq, seed):
    """(batch, seq + 1) int32 tokens in [0, vocab)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)


def train_mask(batch, seq, seed):
    """(batch, seq + 1) bool: about a quarter of the positions dropped."""
    rng = np.random.default_rng(seed)
    return rng.random((batch, seq + 1)) > 0.25


def optim_inputs():
    """A small tree of params and three steps of gradients (the second
    with one large leaf, so clipping bites)."""
    rng = np.random.default_rng(11)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32),
                    "d": np.ones(2, np.float32)}}
    grads = []
    for i in range(3):
        g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": {"c": rng.standard_normal(5).astype(np.float32),
                   "d": rng.standard_normal(2).astype(np.float32)}}
        if i == 1:
            g["a"] = g["a"] * 40.0
        grads.append(g)
    return params, grads


def xent_inputs(s, masked):
    """x (2, s, 8) f32, a (8, 40) head, targets (2, s) in [0, 40) and,
    when ``masked``, a (2, s) mask."""
    rng = np.random.default_rng(17 + s)
    out = {"x": rng.standard_normal((2, s, 8)).astype(np.float32),
           "w": rng.standard_normal((8, 40)).astype(np.float32),
           "targets": rng.integers(0, 40, (2, s)).astype(np.int32)}
    if masked:
        out["mask"] = rng.random((2, s)) > 0.3
    return out


def _optim_cases():
    import jax.numpy as jnp

    from repro.optim import (AdamWConfig, adamw_init, adamw_update,
                             clip_by_global_norm, loss_scale_init,
                             loss_scale_update, warmup_cosine)
    from repro.optim.loss_scale import grads_finite
    params, grads = optim_inputs()
    out = {"adamw": {}}
    for name, cfg in (("default", AdamWConfig()),
                      ("no_clip", AdamWConfig(lr=0.1, weight_decay=0.0,
                                              grad_clip=None))):
        p = {k: jnp.asarray(v) if not isinstance(v, dict)
             else {kk: jnp.asarray(vv) for kk, vv in v.items()}
             for k, v in params.items()}
        st = adamw_init(p)
        steps = []
        for i, g in enumerate(grads):
            p, st, m = adamw_update(cfg, p, g, st, lr_scale=0.5 + 0.25 * i)
            steps.append({"params": _np_tree(p), "m": _np_tree(st.m),
                          "v": _np_tree(st.v), "step": int(st.step),
                          "grad_norm": float(m["grad_norm"])})
        out["adamw"][name] = steps
    clipped, norm = clip_by_global_norm(grads[1], 0.5)
    out["clip"] = {"grads": _np_tree(clipped), "norm": float(norm)}
    out["schedule"] = {
        (w, t): [float(warmup_cosine(s, warmup=w, total=t))
                 for s in SCHEDULE_STEPS]
        for w, t in ((100, 10_000), (0, 100), (10, 100))}
    st = loss_scale_init(1024.0)
    trace = []
    for fin in LOSS_SCALE_FLAGS:
        st = loss_scale_update(st, jnp.asarray(fin), growth_interval=3)
        trace.append((float(st.scale), int(st.good_steps)))
    out["loss_scale"] = trace
    out["finite"] = [bool(grads_finite(grads[0])),
                     bool(grads_finite({"a": jnp.asarray([1.0, jnp.inf])}))]
    return out


def _xent_cases():
    import jax
    import jax.numpy as jnp

    from repro.models.losses import fused_chunked_xent, next_token_xent
    out = {}
    for s, chunk, masked in XENT_CASES:
        inp = xent_inputs(s, masked)
        mask = jnp.asarray(inp["mask"]) if masked else None
        t = jnp.asarray(inp["targets"])

        def fused(x, w):
            return fused_chunked_xent(x, lambda xc: xc @ w, t, mask,
                                      chunk=chunk)[0]

        def plain(x, w):
            return next_token_xent(x @ w, t, mask)[0]

        args = (jnp.asarray(inp["x"]), jnp.asarray(inp["w"]))
        lf, gf = jax.value_and_grad(fused, argnums=(0, 1))(*args)
        lp, gp = jax.value_and_grad(plain, argnums=(0, 1))(*args)
        out[(s, chunk, masked)] = {
            "fused": (float(lf), np.asarray(gf[0]), np.asarray(gf[1])),
            "plain": (float(lp), np.asarray(gp[0]), np.asarray(gp[1]))}
    return out


def _loss_and_grads(api, params, batch, eager=False):
    """``loss_fn``'s value, metrics and gradients, jitted (or, with
    ``eager``, op by op)."""
    import contextlib

    import jax

    fn = jax.value_and_grad(lambda p: api.loss_fn(p, batch), has_aux=True)
    with jax.disable_jit() if eager else contextlib.nullcontext():
        (loss, metrics), grads = (fn if eager else jax.jit(fn))(params)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _np_tree(grads)}


def _jax_state(params):
    import jax.numpy as jnp

    from repro.launch.train import TrainState
    from repro.optim import adamw_init, loss_scale_init
    return TrainState(params, adamw_init(params), loss_scale_init(),
                      jnp.zeros((), jnp.int32))


def _jax_step(api, tc):
    """The oracle of one whole step: ``_grad_step`` then
    ``_apply_updates`` under a plain ``jax.jit`` (the reference's
    ``make_train_step`` needs a mesh)."""
    import jax

    from repro.launch.train import _apply_updates, _grad_step

    def step(state, batch):
        grads, loss, metrics = _grad_step(api, tc, state, batch)
        return _apply_updates(api, tc, state, grads, loss, metrics)

    return jax.jit(step)


def _train_config(case):
    from repro.launch.train import TrainConfig
    from repro.optim import AdamWConfig
    kw = step_config(case)
    return TrainConfig(adamw=AdamWConfig(lr=kw.pop("lr")), **kw)


def task_train():
    """Reduced qwen2-0.5b training: the optimizer pieces on
    ``optim_inputs``, ``fused_chunked_xent`` and ``next_token_xent``
    values and gradients, ``loss_fn`` and its gradients per policy,
    ``N_STEPS`` whole steps per ``STEP_CASES`` case (metrics, the state
    after each step), and a ``TrainState`` checkpoint written after two
    steps (its files), with the third step from it."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from repro.checkpoint import save_checkpoint
    from repro.models import registry

    base = train_config("bf16")
    params = registry.build(base).init(jax.random.PRNGKey(0))
    out = {"params": _np_tree(params), "optim": _optim_cases(),
           "xent": _xent_cases(), "loss": {}, "steps": {}}
    tokens = train_tokens(base.vocab, 2, TRAIN_SEQ, 0)
    mask = train_mask(2, TRAIN_SEQ, 1)
    for pol in TRAIN_POLICIES:
        api = registry.build(train_config(pol))
        out["loss"][(pol, False)] = _loss_and_grads(
            api, params, {"tokens": jnp.asarray(tokens)})
        if pol == "bf16":
            out["loss"][(pol, True)] = _loss_and_grads(
                api, params, {"tokens": jnp.asarray(tokens),
                              "mask": jnp.asarray(mask)})
            out["loss_eager"] = _loss_and_grads(
                api, params, {"tokens": jnp.asarray(tokens)}, eager=True)
    for case, (pol, _, b) in STEP_CASES.items():
        api = registry.build(train_config(pol))
        step = _jax_step(api, _train_config(case))
        state = _jax_state(params)
        metrics, states = [], []
        for i in range(N_STEPS):
            batch = {"tokens": jnp.asarray(
                train_tokens(base.vocab, b, TRAIN_SEQ, 100 + i))}
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(_np_tree(state))
        out["steps"][case] = {"metrics": metrics, "states": states}
    # the checkpoint case: the "plain" steps, saved after the second
    case = out["steps"]["plain"]
    api = registry.build(base)
    state = jax.tree.map(jnp.asarray, case["states"][1])
    from repro.launch.train import TrainState
    state = TrainState(*state)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 2, state, {"note": "reference"})
        out["checkpoint"] = _dir_bytes(os.path.join(d, f"step_{2:09d}"))
    return out


def task_train_families():
    """For each of ``TRAIN_FAMILY_ARCHS`` (reduced, bf16): the init
    params, a batch from the reference's ``materialize_batch`` and
    ``loss_fn``'s value, metrics and gradients on it."""
    import jax

    from repro.configs import reduced
    from repro.configs.base import InputShape
    from repro.models import registry

    out = {}
    for arch in TRAIN_FAMILY_ARCHS:
        cfg = reduced(arch)
        api = registry.build(cfg)
        params = api.init(jax.random.PRNGKey(0))
        batch = registry.materialize_batch(
            cfg, InputShape("train", TRAIN_SEQ, 2, "train"), seed=3)
        out[arch] = {"params": _np_tree(params), "batch": _np_tree(batch),
                     **_loss_and_grads(api, params, batch)}
    return out


TASKS = {"lm": task_lm, "serving": task_serving, "plan": task_plan,
         "checkpoint": task_checkpoint, "router": task_router,
         "arch": task_arch, "rebuild": task_rebuild,
         "family": task_family, "encdec": task_encdec,
         "train": task_train, "train_families": task_train_families}


if __name__ == "__main__":
    task, path = sys.argv[1], sys.argv[2]
    if len(sys.argv) > 3:
        ARCH = sys.argv[3]
    result = TASKS[task]()
    with open(path, "wb") as f:
        pickle.dump(result, f)
