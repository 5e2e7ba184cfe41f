"""Continuous-batching serving engine (mirror of
``repro/serving/engine.py``'s ``ServingEngine``).

Fixed decode slots over one shared decode state on the device (KV
caches, recurrent state, or both), an
:class:`~repro_torch.serving.scheduler.AdmissionScheduler` in front, and
a loop in which prefill and decode interleave, per tick:

* **admission** drains the scheduler into free slots. A family without
  chunked prefill (``vlm``, ``rwkv``, ``griffin``; any family under
  ``prefill="teacher"``) admits by teacher forcing: one decode step per
  prompt token but the last, every other slot fed token 0 at its own
  position, as the reference does (``_step_slot_token``);
* **chunked prefill** (``lm`` under ``"auto"``/``"batched"``) advances
  every prefilling slot by one ``prefill_chunk``-token wave in ONE
  fixed-shape call (``api.prefill_chunk``: a position-offset write into
  the live cache);
* **decode** runs one block of ``decode_block`` steps with on-device
  token selection (``models.registry.make_block_decode``) and syncs the
  host once. ``mid_block_admission`` cuts blocks short while requests
  queue; ``eos_stopping`` zeroes a slot's budget on the device when it
  generates a stop id.

Weights are prepared once at construction (``quant.prepare``) and
activation scales can be calibrated (``act_calibration``); with both,
``fused_executors="auto"`` routes every int/fp projection through the
fused CUDA kernels. The engine runs on the CUDA device unless
``device="cpu"`` is passed, and raises without CUDA otherwise.

Each of the four dispatch programs (decode step, token selection,
prefill wave, blocked decode) goes through the engine's program cache
(``serving.graphs``), the counterpart of the reference's ``jax.jit``: on
a CUDA device it is captured once per input signature into a CUDA graph
and replayed after that; on the CPU it is the eager call. The params
tree and the decode state are the programs' static arguments, bound by
identity (every family updates its state in place).

Host-mirrored slot state (positions, tokens, sampling parameters) lives
in numpy and reaches the device through copying, blocking transfers
into the programs' input buffers: the host mutates those arrays right
after a dispatch, so the device must never read them in place (an async
read of a host buffer mutated after the dispatch is an aliasing bug).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import policy as policy_mod
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.obs import MetricsRegistry, ReplicaStats, Tracer, traced_call
from repro_torch.serving import graphs
from repro_torch.serving.config import (MAX_STOP_IDS, EngineConfig,
                                        SamplingParams)


def _pinned_api(api: registry.ModelAPI, name: str,
                policy: policy_mod.PrecisionPolicy) -> registry.ModelAPI:
    """``api`` whose forwards resolve the policy ``name`` to ``policy``
    (``core.policy.pinned_policy``): the one the engine resolved at
    construction, whatever happens to a ``plan:`` file afterwards."""
    def pin(fn):
        def run(*args, **kwargs):
            with policy_mod.pinned_policy(name, policy):
                return fn(*args, **kwargs)
        return None if fn is None else run

    return api._replace(prefill=pin(api.prefill),
                        decode_step=pin(api.decode_step),
                        prefill_chunk=pin(api.prefill_chunk))


def _with_variant(fn: Callable, name: Optional[str]) -> Callable:
    """Run ``fn`` under ``layers.mplinear.executor_variant(name)``."""
    if name is None:
        return fn
    from repro_torch.layers.mplinear import executor_variant

    def wrapped(*args, **kwargs):
        with executor_variant(name):
            return fn(*args, **kwargs)

    return wrapped


def make_serve_fns(api: registry.ModelAPI, mesh, batch_shape: Dict,
                   cache_len: int, batch_size: int):
    """``(prefill, decode, cache_shardings, param_shardings)`` for a
    ``DeviceMesh``: the prefill and decode steps on sharded params and
    caches (the reference's jitted serve artifacts).

    ``prefill(params, batch, caches)`` places the params by
    ``param_shardings``, the caches by ``cache_shardings`` and the
    prefill inputs of ``batch`` (all but ``token``/``pos``) over the data
    axes, then runs ``api.prefill``; ``decode(params, batch, state)``
    places the params and runs ``api.decode_step`` on the state prefill
    returned. Both return DTensors (logits: batch over data, vocab over
    'model'; ``full_tensor()`` gathers them) and write the caches in
    place. The shardings come from the shapes alone (an init on the meta
    device). Every rank calls them."""
    from repro_torch.parallel import sharding as shd
    cache_shard = shd.cache_shardings(
        api.init_cache(batch_size, cache_len, "meta"), mesh)
    param_shard = shd.param_shardings(api.init(0, "meta"), mesh)
    pf_shard = {k: shd.NamedSharding(mesh, shd.batch_pspec(
                    f"[{k!r}]", tuple(v.shape), mesh))
                for k, v in batch_shape.items() if k not in ("token", "pos")}

    def run(fn, params, batch, state):
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        with torch.no_grad(), implicit_replication():
            return fn(shd.distribute(params, param_shard), batch, state)

    def prefill(params, batch, caches):
        batch = {**batch, **shd.distribute(
            {k: batch[k] for k in pf_shard}, pf_shard)}
        return run(api.prefill, params, batch,
                   shd.distribute(caches, cache_shard))

    def decode(params, batch, state):
        return run(api.decode_step, params, batch, state)

    return prefill, decode, cache_shard, param_shard


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    priority: int = 0            # lower admits first (see scheduler)
    tags: Tuple[str, ...] = ()
    tokens: Optional[List[int]] = None
    done: bool = False
    error: Optional[str] = None
    next_input: Optional[int] = None
    submit_time: Optional[float] = None
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    sampling: SamplingParams = SamplingParams()
    finish_reason: Optional[str] = None   # 'length' | 'stop'
    truncated: bool = False
    prefill_pos: int = 0

    @property
    def new_tokens(self) -> int:
        return 0 if self.tokens is None else len(self.tokens) - len(self.prompt)

    @property
    def budget(self) -> int:
        if self.sampling.max_new_tokens is not None:
            return self.sampling.max_new_tokens
        return self.max_new_tokens


# families whose decode state only a prefill makes (encdec: the KV caches
# and the encoder output); the reference's engine fails on them at its
# first decode, the port's refuses them at construction
_UNSERVED_FAMILIES = ("encdec",)


class ServingEngine:
    """Slot-based continuous batching with chunked or teacher-forced
    prefill admission."""

    def __init__(self, cfg: ModelConfig, api: registry.ModelAPI, params,
                 config: Optional[EngineConfig] = None, *,
                 scheduler=None,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        from repro_torch.convert import tree_to
        from repro_torch.serving.scheduler import AdmissionScheduler
        if cfg.family in _UNSERVED_FAMILIES:
            raise ValueError(
                f"family {cfg.family!r} cannot be served: its decode state "
                f"(caches, encoder output) exists only after a prefill with "
                f"frames; call registry.build(cfg).prefill/decode_step")
        self.device = resolve_device(device)
        self.config = config if config is not None else EngineConfig()
        self.cfg = cfg
        self.b = self.config.batch_slots
        self.cache_len = self.config.cache_len
        self.clock = clock
        self.policy = policy_mod.get_policy(cfg.precision_policy)
        self.api = api = _pinned_api(api, cfg.precision_policy, self.policy)
        self.decode_block = self.config.decode_block
        if self.decode_block > 1 and not registry.block_decode_eligible(cfg):
            raise ValueError(
                f"family {cfg.family!r} is not eligible for blocked decode")
        params = tree_to(params, self.device)
        self.prepared = bool(self.config.prepare_weights) \
            and api.prepare is not None
        self.act_scales = self._resolve_act_scales(
            self.config.act_calibration, params)
        self.params = api.prepare(params, self.policy,
                                  act_scales=self.act_scales) \
            if self.prepared else params
        self.fused = self._resolve_fused(params)
        self._variant = "fused" if self.fused else None
        self.caches = api.init_cache(self.b, self.cache_len, self.device)
        self.pos = np.zeros(self.b, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * self.b
        self.scheduler = scheduler if scheduler is not None \
            else AdmissionScheduler()
        self.completed: Dict[int, Request] = {}
        # the chunked path needs a prefill that consumes only tokens into
        # position-tagged (padding-safe) caches: the API's prefill_chunk
        prefill = self.config.prefill
        chunked = api.prefill_chunk is not None
        if prefill == "batched" and not chunked:
            raise ValueError(
                f"batched prefill needs a position-tagged token-only "
                f"prefill; family {cfg.family!r} is not eligible")
        self._fast_prefill = chunked if prefill == "auto" \
            else prefill == "batched"
        if self.decode_block > 1:
            uncovered = self._dynamic_fake_int_paths(params)
            if uncovered:
                raise ValueError(
                    "decode_block > 1 needs per-slot-independent decode, "
                    "but dynamically-scaled fake-quant projections couple "
                    "batch rows through their shared per-tensor activation "
                    f"absmax ({sorted(uncovered)[:3]}...); calibrate static "
                    "activation scales (act_calibration='auto' or a "
                    "calibrate_act_scales dict) or serve exact int kernels")
        self.registry = MetricsRegistry()
        for k in ("ticks", "decode_steps", "host_syncs",
                  "prefill_calls", "prefill_tokens",
                  "teacher_forced_tokens", "admitted", "submitted",
                  "short_blocks", "mid_block_admits", "eos_stops"):
            self.registry.counter(k)
        self.counters = self.registry.counters_view()
        self.tracer = Tracer(clock=self.clock, enabled=self.config.trace)
        self.stats = ReplicaStats(alpha=self.config.stats_alpha,
                                  window=self.config.stats_window)
        w = self.config.stats_window
        self._g_tok = self.registry.rolling("tok_per_tick", w)
        self._g_queue = self.registry.rolling("queue_depth", w)
        self._g_occ = self.registry.rolling("batch_occupancy", w)
        self._g_short = self.registry.rolling("short_block", w)
        self._graphs = graphs.Programs(self.device)
        self._decode = self._program(
            _with_variant(lambda p, c, tok, pos: api.decode_step(
                p, {"token": tok, "pos": pos}, c), self._variant),
            2, "decode_step")
        self._temp = np.zeros(self.b, np.float32)
        self._topk = np.zeros(self.b, np.int32)
        self._topp = np.ones(self.b, np.float32)
        self._stops = np.full((self.b, MAX_STOP_IDS), -1, np.int32)
        self._keys = np.zeros((self.b, 2), np.int64)
        self._stop_sets: List[frozenset] = [frozenset()] * self.b
        from repro_torch.models.sampling import sample_tokens
        self._select = self._program(sample_tokens, 0, "select")
        # the chunk is bounded by the smallest cache ring, so a chunk's
        # positions occupy distinct slots within each row
        self.prefill_chunk = self.config.prefill_chunk
        self._prefill_chunk_fn = None
        if api.prefill_chunk is not None:
            caps = [c.shape[-1] for p, c in graphs.leaves(self.caches)
                    if p[-1] == "pos"]
            self.prefill_chunk = max(
                min(self.prefill_chunk, min(caps), self.cache_len), 1)
            self._prefill_chunk_fn = self._program(
                _with_variant(
                    lambda p, c, tokens, offs, lens: api.prefill_chunk(
                        p, {"tokens": tokens, "offsets": offs,
                            "lengths": lens}, c),
                    self._variant),
                2, "prefill_chunk")
        self._block_fns: Dict[Tuple[int, bool], Callable] = {}
        self._last_block_short = False
        from repro_torch.quant.prepare import weight_resident_bytes
        self._weight_bytes = weight_resident_bytes(
            self.params, registry.projection_paths(self.cfg))

    def _program(self, fn: Callable, n_static: int, name: str) -> Callable:
        """``fn(*static, *dynamic)`` through the program cache, its
        compilations spanned as ``compile:<name>``."""
        return traced_call(self._graphs.program(fn, n_static, name), name,
                           self.tracer)

    def _resolve_act_scales(self, act_calibration, params):
        """None | mapping | 'auto' -> {policy path: static scale}.

        'auto' prefers scales embedded in a ``plan:`` artifact (the plan
        carries its calibration, which assumes it was calibrated on the
        weights this replica serves) and otherwise runs a short
        random-token calibration pass over the raw params."""
        if act_calibration is None:
            return None
        if not self.prepared:
            raise ValueError("act_calibration requires prepared weights "
                             "(prepare_weights=True)")
        if isinstance(act_calibration, dict):
            return dict(act_calibration)
        if act_calibration != "auto":
            raise ValueError(
                f"act_calibration must be None, a dict or 'auto', got "
                f"{act_calibration!r}")
        if not self._routes_int(params):
            return None
        pol = self.cfg.precision_policy
        if pol.startswith("plan:"):
            from repro_torch.autotune.plan import load_act_scales
            scales = load_act_scales(pol[len("plan:"):])
            if scales:
                return scales
        from repro_torch.quant.calibrate import calibrate_act_scales
        return calibrate_act_scales(self.cfg, self.api, params,
                                    device=self.device)

    def _resolve_fused(self, params) -> bool:
        mode = self.config.fused_executors
        if mode == "off":
            return False
        if mode == "on":
            if not self.prepared:
                raise ValueError(
                    "fused_executors='on' requires prepared weights "
                    "(the fused kernels consume prepared storage)")
            return True
        return self.prepared and (self.act_scales is not None
                                  or self._routes_fp(params))

    def _specs(self, params):
        from repro_torch.quant.prepare import iter_projection_weights
        paths = registry.projection_paths(self.cfg)
        return [(paths(prefix), self.policy.spec_for(paths(prefix)))
                for prefix, _ in iter_projection_weights(params, paths)]

    def _routes_fp(self, params) -> bool:
        return any(s.mode in ("fp8", "fp4") for _, s in self._specs(params))

    def _routes_int(self, params) -> bool:
        return any(s.weight_bits for _, s in self._specs(params))

    def _dynamic_fake_int_paths(self, params) -> set:
        scales = self.act_scales or {}
        return {p for p, s in self._specs(params)
                if p != "block/moe/experts" and s.weight_bits
                and not s.exact and p not in scales}

    # ------------------------------------------------------- observability

    @torch.no_grad()
    def _trace_decode(self, hook):
        """Run ONE decode step of the program the engine dispatches (the
        plain step at ``decode_block=1``, the blocked program with its
        staging walk otherwise) on a copy of the caches, under a capture
        context manager, and return what the context yielded."""
        caches = graphs.clone_tree(self.caches)
        zeros = torch.zeros(self.b, dtype=torch.int32, device=self.device)
        with hook() as captured:
            if self.decode_block > 1:
                fn = registry.make_block_decode(self.api, 1,
                                                policy=self.policy,
                                                fused=self.fused)
                carry = registry.DecodeCarry(
                    tok=zeros, pos=zeros,
                    rem=torch.ones_like(zeros), taken=zeros,
                    stops=torch.full((self.b, MAX_STOP_IDS), -1,
                                     dtype=torch.int32, device=self.device),
                    temp=torch.zeros(self.b, device=self.device),
                    top_k=zeros,
                    top_p=torch.ones(self.b, device=self.device),
                    keys=torch.zeros((self.b, 2), dtype=torch.int64,
                                     device=self.device))
                fn(self.params, carry, caches)
            else:
                _with_variant(self.api.decode_step, self._variant)(
                    self.params, {"token": zeros[:, None], "pos": zeros},
                    caches)
        return captured

    @torch.no_grad()
    def _check_replays(self, sample: bool) -> Dict[str, List[str]]:
        """Hold one replay of each of the engine's programs (the prefill
        wave where the family has one, the decode step, selection, and
        the decode block where the family is eligible) bit for bit
        against the same program run eagerly on cloned state
        (``graphs.check_replay``), at this engine's shapes with seeded
        inputs, greedy or sampled: {program: leaves that differ}. The
        decode state is restored afterwards."""
        from repro_torch.models.sampling import make_key
        b, chunk, n = self.b, self.prefill_chunk, self.decode_block
        rng = np.random.default_rng(0)
        saved = graphs.clone_tree(self.caches)
        tokens = rng.integers(0, self.cfg.vocab, (b, chunk), dtype=np.int32)
        offs = np.zeros(b, np.int32)
        lens = np.full(b, chunk, np.int32)
        tok, pos = tokens[:, -1], lens.copy()
        temp = np.full(b, 0.8 if sample else 0.0, np.float32)
        top_k = np.full(b, 40, np.int32)
        top_p = np.full(b, 0.95, np.float32)
        keys = np.array([make_key(self.config.seed, i + 1) for i in range(b)],
                        np.int64)
        prog = lambda fn: getattr(fn, "__wrapped__", fn)  # noqa: E731
        out = {}
        if self._prefill_chunk_fn is not None:
            out["prefill_chunk"] = graphs.check_replay(
                prog(self._prefill_chunk_fn), self.params, self.caches,
                tokens, offs, lens)
        out["decode_step"] = graphs.check_replay(
            prog(self._decode), self.params, self.caches, tok[:, None], pos)
        logits, _ = self._decode(self.params, self.caches, tok[:, None], pos)
        out["select"] = graphs.check_replay(
            prog(self._select), keys, logits.clone(), temp, top_k, top_p)
        if registry.block_decode_eligible(self.cfg):
            carry = registry.DecodeCarry(
                tok=tok, pos=pos, rem=np.full(b, n, np.int32),
                taken=np.zeros(b, np.int32),
                stops=np.full((b, MAX_STOP_IDS), -1, np.int32), temp=temp,
                top_k=top_k, top_p=top_p, keys=keys)
            out[f"block_decode[n={n}]"] = graphs.check_replay(
                prog(self._block_decode(n, sample)), self.params,
                self.caches, carry)
        for (_, dst), (_, src) in zip(graphs.leaves(self.caches),
                                      graphs.leaves(saved)):
            dst.copy_(src)
        return out

    def routing_report(self) -> Dict[str, str]:
        """(policy path -> datapath mode) observed in one decode step."""
        return dict(self._trace_decode(policy_mod.trace_routing))

    def weight_bytes(self) -> Dict:
        return self._weight_bytes

    def weight_quant_trace_count(self) -> int:
        """Dynamic weight quantizations in ONE decode step (zero for
        prepared replicas)."""
        from repro_torch.layers import mplinear
        return self._trace_decode(mplinear.count_weight_quant)[0]

    def act_quant_trace_count(self) -> int:
        """Per-token activation absmax reduces in ONE decode step (zero
        for calibrated replicas)."""
        from repro_torch.layers import mplinear
        return self._trace_decode(mplinear.count_act_quant)[0]

    def staged_trace_count(self) -> int:
        """Staged compute-dtype operands materialized in ONE decode
        dispatch (zero on the fused datapath)."""
        from repro_torch.quant import prepare
        return self._trace_decode(prepare.count_staged)[0]

    def metrics(self) -> Dict:
        from repro_torch.serving.metrics import summarize_requests
        m = summarize_requests(self.completed.values())
        m["counters"] = dict(self.counters)
        m["queue"] = len(self.scheduler)
        m["queue_highwater"] = self.scheduler.depth_highwater
        m["active_slots"] = sum(r is not None for r in self.slot_req)
        m["prepared_weights"] = self.prepared
        m["act_calibrated"] = self.act_scales is not None
        m["fused_executors"] = self.fused
        m["decode_block"] = self.decode_block
        m["mid_block_admission"] = self.config.mid_block_admission
        m["eos_stopping"] = self.config.eos_stopping
        m["weight_bytes"] = self.weight_bytes()
        m["gauges"] = self.registry.snapshot()["rolling"]
        m["replica_stats"] = self.stats.snapshot()
        m["trace"] = {"enabled": self.tracer.enabled,
                      "events": len(self.tracer.events),
                      "dropped": self.tracer.dropped}
        m["graphs"] = self._graphs.stats()
        m["device"] = str(self.device)
        return m

    def dump_trace(self, path: str) -> str:
        if not self.tracer.enabled:
            raise RuntimeError(
                "tracing is off — construct the engine with "
                "EngineConfig(trace=True)")
        return self.tracer.dump(path)

    def has_pending(self) -> bool:
        return (len(self.scheduler) > 0
                or any(r is not None for r in self.slot_req))

    # ------------------------------------------------------------ admission

    def _capacity_needed(self, req: Request) -> int:
        if req.budget <= 0:
            return 0
        return max(len(req.prompt) - 1, 0) + req.budget

    def submit(self, req: Request):
        if not isinstance(req.sampling, SamplingParams):
            raise TypeError(
                f"req{req.rid}.sampling must be a SamplingParams, got "
                f"{type(req.sampling).__name__}")
        if len(self._merged_stops(req)) > MAX_STOP_IDS:
            raise ValueError(
                f"req{req.rid}: stop_ids + engine eos_id exceed the "
                f"{MAX_STOP_IDS} per-slot stop slots")
        self.scheduler.submit(req, now=self.clock())
        self.counters["submitted"] += 1
        self.tracer.req_begin(req.rid, "queued",
                              args={"prompt_len": len(req.prompt),
                                    "budget": req.budget})

    def _merged_stops(self, req: Request) -> Tuple[int, ...]:
        stops = list(req.sampling.stop_ids)
        if self.config.eos_id is not None \
                and self.config.eos_id not in stops:
            stops.append(self.config.eos_id)
        return tuple(stops)

    def _install_sampling(self, slot: int, req: Request):
        from repro_torch.models.sampling import make_key
        sp = req.sampling
        self._temp[slot] = sp.temperature
        self._topk[slot] = sp.top_k
        self._topp[slot] = sp.top_p
        stops = self._merged_stops(req) if self.config.eos_stopping else ()
        self._stops[slot] = -1
        self._stops[slot, :len(stops)] = stops
        self._stop_sets[slot] = frozenset(stops)
        # explicit seed, else the engine seed mixed with the rid:
        # placement- and block-size-independent
        if sp.seed is not None:
            self._keys[slot] = make_key(sp.seed)
        else:
            self._keys[slot] = make_key(self.config.seed, req.rid + 1)

    def _clear_sampling(self, slot: int):
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 1.0
        self._stops[slot] = -1
        self._keys[slot] = 0
        self._stop_sets[slot] = frozenset()

    def _admit(self):
        free = [s for s in range(self.b) if self.slot_req[s] is None]
        if not free:
            return
        now = self.clock()
        teacher: List[Tuple[int, Request]] = []
        for req in self.scheduler.select(len(free), now):
            req.admit_time = now
            req.tokens = [int(t) for t in req.prompt]
            self.counters["admitted"] += 1
            self.tracer.req_end(req.rid, "queued")
            if req.budget <= 0 or len(req.prompt) == 0:
                req.done = True
                req.finish_reason = "length"
                req.finish_time = now
                self.completed[req.rid] = req
                self.tracer.req_instant(req.rid, "finished",
                                        args={"reason": "length"})
                continue
            if self._capacity_needed(req) > self.cache_len:
                req.truncated = True
            slot = free.pop(0)
            self.slot_req[slot] = req
            self._install_sampling(slot, req)
            if self._last_block_short:
                self.counters["mid_block_admits"] += 1
            req.prefill_pos = 0
            self.tracer.req_begin(req.rid, "prefill", args={"slot": slot})
            self.pos[slot] = 0
            if len(req.prompt) == 1:
                req.next_input = int(req.prompt[0])
                self._req_decode_start(req)
            elif self._fast_prefill:
                req.next_input = None     # prefills in chunk waves
            else:
                req.next_input = int(req.prompt[-1])
                teacher.append((slot, req))
        for slot, req in teacher:
            for t in req.prompt[:-1]:
                self._step_slot_token(slot, int(t))
            req.prefill_pos = len(req.prompt) - 1
            self.counters["teacher_forced_tokens"] += len(req.prompt) - 1
            self._req_decode_start(req)

    def _req_decode_start(self, req: Request):
        if self.tracer.enabled:
            self.tracer.req_end(req.rid, "prefill")
            self.tracer.req_begin(req.rid, "decode")

    def _prefill_tick(self) -> bool:
        """Advance every prefilling slot by one chunk in ONE call."""
        pref = [(s, r) for s, r in enumerate(self.slot_req)
                if r is not None and r.next_input is None]
        if not pref:
            return False
        chunk = self.prefill_chunk
        tokens = np.zeros((self.b, chunk), np.int32)
        offs = np.zeros(self.b, np.int32)
        lens = np.zeros(self.b, np.int32)
        total = 0
        for s, req in pref:
            todo = len(req.prompt) - 1 - req.prefill_pos
            take = min(chunk, todo)
            tokens[s, :take] = np.asarray(
                req.prompt[req.prefill_pos:req.prefill_pos + take], np.int32)
            offs[s] = req.prefill_pos
            lens[s] = take
            total += take
        with self.tracer.span("prefill_dispatch",
                              args={"tokens": total, "slots": len(pref)}):
            self.caches = self._prefill_chunk_fn(
                self.params, self.caches, tokens, offs, lens)
        self.counters["prefill_calls"] += 1
        self.counters["prefill_tokens"] += total
        for s, req in pref:
            req.prefill_pos += int(lens[s])
            if req.prefill_pos >= len(req.prompt) - 1:
                self.pos[s] = len(req.prompt) - 1
                req.next_input = int(req.prompt[-1])
                self._req_decode_start(req)
            else:
                self.pos[s] = req.prefill_pos
        return True

    def _step_slot_token(self, slot: int, token: int) -> int:
        """Teacher forcing: one decode step (the engine's ``decode_step``
        program) feeds ``token`` to ``slot``; every other slot is fed
        token 0 at its own position, as in the reference. For recurrent
        state that pad folds into the other slots' state, as it does in
        the reference. Returns the slot's argmax (one host sync)."""
        tok = np.zeros((self.b, 1), np.int32)
        tok[slot, 0] = token
        logits, self.caches = self._decode(self.params, self.caches, tok,
                                           self.pos)
        self.pos[slot] += 1
        self.counters["host_syncs"] += 1
        return int(torch.argmax(logits[slot]))

    # --------------------------------------------------------- decode loop

    def _block_decode(self, n: int, sample: bool) -> Callable:
        fn = self._block_fns.get((n, sample))
        if fn is None:
            kind = "sample" if sample else "greedy"
            run = registry.make_block_decode(
                self.api, n, policy=self.policy, sample=sample,
                tracer=self.tracer, fused=self.fused)
            fn = self._program(lambda p, c, carry: run(p, carry, c), 2,
                               f"block_decode[n={n},{kind}]")
            self._block_fns[(n, sample)] = fn
        return fn

    def _finish_slot(self, s: int, now: float, reason: str):
        req = self.slot_req[s]
        req.done = True
        req.finish_time = now
        req.finish_reason = reason
        if reason == "stop":
            self.counters["eos_stops"] += 1
        if self.tracer.enabled:
            self.tracer.req_end(req.rid, "decode")
            self.tracer.req_instant(
                req.rid, "finished",
                args={"reason": reason, "new_tokens": req.new_tokens})
        self.completed[req.rid] = req
        self.slot_req[s] = None
        self.pos[s] = 0
        self._clear_sampling(s)

    def _stop_hit(self, s: int, token: int) -> bool:
        return bool(self._stop_sets[s]) and token in self._stop_sets[s]

    def _choose_block(self, rem: np.ndarray) -> int:
        """Block length: while requests queue, cut at the nearest
        completion or ceil(decode_block / (1 + depth)), whichever comes
        first, never below half the configured block."""
        alive = rem[rem > 0]
        full = int(min(self.decode_block, int(alive.max())))
        depth = len(self.scheduler)
        if self.config.mid_block_admission and depth > 0:
            cut = min(int(alive.min()),
                      -(-self.decode_block // (1 + depth)))
            return max(1, min(full, max(cut, self.decode_block // 2)))
        return max(full, 1)

    def _first_token(self, req: Request, now: float):
        req.first_token_time = now
        if req.submit_time is not None:
            self.stats.observe_ttft(now - req.submit_time)
        self.tracer.req_instant(req.rid, "first_token")

    def _sample_tick(self, new_tokens: int):
        now = self.clock()
        occupied = sum(r is not None for r in self.slot_req)
        depth = len(self.scheduler)
        self.stats.on_tick(now, new_tokens, depth, active_slots=occupied)
        self._g_tok.observe(now, new_tokens)
        self._g_queue.observe(now, depth)
        self._g_occ.observe(now, occupied / self.b)
        if self.decode_block > 1:
            self._g_short.observe(
                now, 1.0 if self._last_block_short else 0.0)

    @torch.no_grad()
    def step(self):
        """One tick: admit, advance prefilling slots one chunk, run one
        decode block (one host sync) for the decodable slots."""
        with self.tracer.span("admission"):
            self._admit()
        self.counters["ticks"] += 1
        prefilled = self._prefill_tick()
        active = [s for s, r in enumerate(self.slot_req)
                  if r is not None and r.next_input is not None]
        if not active:
            self._sample_tick(0)
            return prefilled
        if self.decode_block > 1:
            return self._step_block(active)
        self._last_block_short = False
        tok = np.zeros((self.b, 1), np.int32)
        for s in active:
            tok[s, 0] = self.slot_req[s].next_input
        with self.tracer.span("block_dispatch", args={"n": 1}):
            logits, self.caches = self._decode(
                self.params, self.caches, tok, self.pos)
        self.counters["decode_steps"] += 1
        self.counters["host_syncs"] += 1
        with self.tracer.span("host_sync"):
            if any(self._temp[s] > 0 for s in active):
                keys2, nxt = self._select(self._keys, logits, self._temp,
                                          self._topk, self._topp)
                nxt = nxt.cpu().numpy()
                keys2 = keys2.cpu().numpy()
                for s in active:
                    self._keys[s] = keys2[s]
            else:
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        now = self.clock()
        with self.tracer.span("harvest"):
            for s in active:
                req = self.slot_req[s]
                self.pos[s] += 1
                if req.first_token_time is None:
                    self._first_token(req, now)
                t = int(nxt[s])
                req.tokens.append(t)
                req.next_input = t
                if self.config.eos_stopping and self._stop_hit(s, t):
                    self._finish_slot(s, now, "stop")
                elif req.new_tokens >= req.budget:
                    self._finish_slot(s, now, "length")
        self._sample_tick(len(active))
        return True

    def _step_block(self, active: List[int]) -> bool:
        """Run one decode block in ONE dispatch and sync its token
        trajectory once; each slot's active prefix comes back in
        ``carry.taken``."""
        rem = np.zeros(self.b, np.int32)
        tok = np.zeros(self.b, np.int32)
        for s in active:
            req = self.slot_req[s]
            rem[s] = req.budget - req.new_tokens
            tok[s] = req.next_input
        n = self._choose_block(rem)
        full = int(min(self.decode_block, int(rem.max())))
        self._last_block_short = n < full
        if self._last_block_short:
            self.counters["short_blocks"] += 1
        sample = bool(any(self._temp[s] > 0 for s in active))
        carry = registry.DecodeCarry(
            tok=tok, pos=self.pos, rem=rem,
            taken=np.zeros(self.b, np.int32), stops=self._stops,
            temp=self._temp, top_k=self._topk, top_p=self._topp,
            keys=self._keys)
        with self.tracer.span("block_dispatch", args={"n": n}):
            tokens, out, self.caches = self._block_decode(n, sample)(
                self.params, self.caches, carry)
        with self.tracer.span("host_sync"):
            tokens = tokens.cpu().numpy()      # ONE host sync per block
            taken = out.taken.cpu().numpy()
            rem_after = out.rem.cpu().numpy()
            keys_after = out.keys.cpu().numpy()
        self.counters["decode_steps"] += n
        self.counters["host_syncs"] += 1
        now = self.clock()
        harvested = 0
        with self.tracer.span("harvest"):
            for s in active:
                req = self.slot_req[s]
                steps = int(taken[s])
                harvested += steps
                if req.first_token_time is None:
                    self._first_token(req, now)
                req.tokens.extend(int(t) for t in tokens[:steps, s])
                req.next_input = int(tokens[steps - 1, s])
                self.pos[s] += steps
                self._keys[s] = keys_after[s]
                if int(rem_after[s]) == 0:
                    last = int(tokens[steps - 1, s])
                    reason = "stop" if (self.config.eos_stopping
                                        and self._stop_hit(s, last)) \
                        else "length"
                    self._finish_slot(s, now, reason)
        self._sample_tick(harvested)
        return True

    def run_until_drained(self, max_ticks: int = 10_000):
        ticks = 0
        while self.has_pending():
            self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("engine did not drain")
        return ticks
