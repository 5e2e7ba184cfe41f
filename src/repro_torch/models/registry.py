"""Uniform model API across the served families (mirror of
``repro/models/registry.py``): ``lm``, ``vlm``, ``rwkv``, ``griffin``
and ``encdec``.

``build(cfg)`` -> :class:`ModelAPI` with ``init(seed, device, draws)``,
``loss_fn(params, batch) -> (loss, {"nll", "aux"})`` (training),
``prefill``, ``decode_step``, ``prefill_chunk`` (``lm`` only; None
elsewhere), ``init_cache(batch, max_len, device)`` and the ``prepare``
hook; ``encdec``'s prefill also takes ``batch["frames"]`` and returns
the decode state ``(caches, enc_out)`` its decode steps take;
``projection_paths`` maps parameter-tree containers to policy paths;
``projection_groups`` lists every family's precision-tuning units (the
router's cost model reads them);
``make_block_decode`` builds the blocked decode program the engine
dispatches once per block (``lm`` and ``vlm``); ``input_specs`` gives a
step kind's batch shapes and dtypes and ``materialize_batch`` draws such
a batch from a numpy seed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import InputShape, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, griffin, lm, rwkv, vlm
from repro_torch.models.losses import fused_chunked_xent


@dataclasses.dataclass(frozen=True)
class ProjGroup:
    """One tunable projection group of an architecture.

    ``pattern`` is the policy-rule regex matching every parameter path the
    group's matmuls route through (the same paths the layers pass to
    ``PrecisionPolicy.spec_for``); (d_in, d_out, count) give the matmul
    shape the accelerator models score (count = matmuls of that shape per
    forward pass).
    """

    name: str
    pattern: str
    d_in: int
    d_out: int
    count: int

    @property
    def macs_per_token(self) -> int:
        return self.d_in * self.d_out * self.count


def projection_groups(cfg: ModelConfig) -> Tuple["ProjGroup", ...]:
    """The per-layer precision-tuning units of an architecture — what
    the autotune planner enumerates candidates over. Grouping is by role
    (qkv / attn-out / ffn-in / ffn-out / head), the granularity at which
    mixed-precision schemes are actually deployed (paper Appendix B).

    Patterns must match the literal paths the layers pass to
    ``PrecisionPolicy.spec_for`` ('block/full/attn/wq', 'block/mix/w_r',
    'block/rec/w_in_rnn', 'dec/xattn/wo', ...): a pattern that matches
    nothing makes the rule dead at serve time and the divergence probe
    silently measure zero.
    """
    hd = cfg.head_dim_
    groups = []
    # layers that carry attention / per-family projection counts
    n_attn = cfg.n_layers
    n_ffn = cfg.n_layers
    if cfg.family == "griffin":
        # (rec, rec, attn) repeating pattern + trailing blocks: only the
        # 'attn' slots have attention, every block has an MLP
        pat = cfg.rec_pattern or ("rec", "rec", "attn")
        n_triples = cfg.n_layers // len(pat)
        tail = pat[:cfg.n_layers - n_triples * len(pat)]
        n_attn = n_triples * pat.count("attn") + tail.count("attn")
    elif cfg.family == "encdec":
        # encoder self + decoder self + decoder cross-attention (the
        # xattn paths match the same attn/w* patterns)
        n_enc = cfg.n_enc_layers or cfg.n_layers
        n_attn = n_enc + 2 * cfg.n_layers
        n_ffn = n_enc + cfg.n_layers
    if cfg.family in ("lm", "vlm", "griffin", "encdec"):
        groups += [
            ProjGroup("attn_qkv", r"attn/w[qkv]$", cfg.d_model,
                      (cfg.n_heads + 2 * cfg.n_kv_heads) * hd, n_attn),
            ProjGroup("attn_wo", r"attn/wo$", cfg.n_heads * hd,
                      cfg.d_model, n_attn),
        ]
    if cfg.family == "rwkv":
        groups += [
            ProjGroup("tmix_rkvg", r"mix/w_[rkvg]$", cfg.d_model,
                      cfg.d_model, 4 * cfg.n_layers),
            ProjGroup("tmix_out", r"mix/w_o$", cfg.d_model, cfg.d_model,
                      cfg.n_layers),
            ProjGroup("cmix", r"mix/c_(key|val|rec)$", cfg.d_model,
                      cfg.d_ff, 2 * cfg.n_layers),
        ]
    if cfg.family == "griffin" and cfg.d_rnn:
        n_rec = cfg.n_layers - n_attn
        groups += [
            ProjGroup("rglru_in", r"rec/w_in_(rnn|gate)$", cfg.d_model,
                      cfg.d_rnn, 2 * n_rec),
            ProjGroup("rglru_out", r"rec/w_out$", cfg.d_rnn, cfg.d_model,
                      n_rec),
        ]
    if cfg.moe:
        groups.append(ProjGroup(
            "moe_experts", r"moe/experts$", cfg.d_model, cfg.moe.d_expert,
            3 * cfg.moe.top_k * cfg.n_layers))
    elif cfg.family != "rwkv":
        groups += [
            ProjGroup("ffn_in", r"mlp/w_(gate|up)$", cfg.d_model,
                      cfg.d_ff, 2 * n_ffn),
            ProjGroup("ffn_out", r"mlp/w_down$", cfg.d_ff, cfg.d_model,
                      n_ffn),
        ]
    if cfg.family == "vlm":
        groups.append(ProjGroup(
            "projector", r"projector/fc[12]$", cfg.vit_dim or cfg.d_model,
            cfg.d_model, 2))
    groups.append(ProjGroup(
        "head", r"lm_head|embed|frontend_proj", cfg.d_model,
        cfg.padded_vocab, 1))
    return tuple(groups)


def _lm_projection_paths(cfg: ModelConfig) -> Callable[[str], Optional[str]]:
    kinds = lm.group_kinds(cfg)

    def path_for(p: str) -> Optional[str]:
        m = re.fullmatch(r"blocks/b(\d+)/attn/(w[qkvo])", p)
        if m:
            return f"block/{kinds[int(m.group(1))]}/attn/{m.group(2)}"
        m = re.fullmatch(r"blocks/b\d+/mlp/(w_(?:gate|up|down))", p)
        if m:
            return f"block/mlp/{m.group(1)}"
        if re.fullmatch(r"blocks/b\d+/moe/(?:w_gate|w_up|w_down)", p):
            return "block/moe/experts"
        return None

    return path_for


def _vlm_projection_paths(cfg: ModelConfig
                          ) -> Callable[[str], Optional[str]]:
    base = _lm_projection_paths(cfg)

    def path_for(p: str) -> Optional[str]:
        m = re.fullmatch(r"projector/(fc[12])", p)
        if m:
            return f"projector/{m.group(1)}"
        return base(p)

    return path_for


def _rwkv_projection_paths(cfg: ModelConfig
                           ) -> Callable[[str], Optional[str]]:
    def path_for(p: str) -> Optional[str]:
        m = re.fullmatch(r"blocks/mix/(w_[rkvgo]|c_(?:key|val|rec))", p)
        if m:
            return f"block/mix/{m.group(1)}"
        return None

    return path_for


def _griffin_projection_paths(cfg: ModelConfig
                              ) -> Callable[[str], Optional[str]]:
    def path_for(p: str) -> Optional[str]:
        m = re.fullmatch(
            r"(?:blocks/b\d+|tail/\d+)/rec/(w_in_rnn|w_in_gate|w_out)", p)
        if m:
            return f"block/rec/{m.group(1)}"
        m = re.fullmatch(r"(?:blocks/b\d+|tail/\d+)/attn/(w[qkvo])", p)
        if m:
            return f"block/attn/{m.group(1)}"
        m = re.fullmatch(
            r"(?:blocks/b\d+|tail/\d+)/mlp/(w_(?:gate|up|down))", p)
        if m:
            return f"block/mlp/{m.group(1)}"
        return None

    return path_for


def _encdec_projection_paths(cfg: ModelConfig
                             ) -> Callable[[str], Optional[str]]:
    def path_for(p: str) -> Optional[str]:
        if p == "frontend_proj":
            return "frontend_proj"
        m = re.fullmatch(r"enc_blocks/(attn/w[qkvo]|mlp/w_(?:gate|up|down))",
                         p)
        if m:
            return f"enc/{m.group(1)}"
        m = re.fullmatch(r"dec_blocks/((?:attn|xattn)/w[qkvo]"
                         r"|mlp/w_(?:gate|up|down))", p)
        if m:
            return f"dec/{m.group(1)}"
        return None

    return path_for


_PROJECTION_PATHS = {
    "lm": _lm_projection_paths,
    "vlm": _vlm_projection_paths,
    "rwkv": _rwkv_projection_paths,
    "griffin": _griffin_projection_paths,
    "encdec": _encdec_projection_paths,
}


def projection_paths(cfg: ModelConfig) -> Callable[[str], Optional[str]]:
    """Container path -> policy path for every projection the policy
    routes; None for everything else (embeddings, norms, untied heads,
    the rwkv decay LoRA, the RG-LRU gates)."""
    return _PROJECTION_PATHS[cfg.family](cfg)


def _prepare_fn(cfg: ModelConfig) -> Callable:
    def prepare(params, policy, act_scales=None):
        from repro_torch.quant.prepare import prepare_params
        return prepare_params(params, policy, projection_paths(cfg),
                              act_scales=act_scales)

    return prepare


# families eligible for blocked decode: the pad steps a spent slot keeps
# taking inside a block must be invisible, which holds for
# position-tagged KV caches but not for recurrent state (rwkv and griffin
# fold every token in), as in the reference
_BLOCK_DECODE_FAMILIES = ("lm", "vlm")


def block_decode_eligible(cfg: ModelConfig) -> bool:
    return cfg.family in _BLOCK_DECODE_FAMILIES


class DecodeCarry(NamedTuple):
    """Per-slot state of the blocked decode program (batch-leading device
    tensors): current token, position, remaining budget (0 = inactive),
    steps taken this block, stop ids (-1 unused), sampling parameters and
    the (B, 2) random keys (``models.sampling``)."""

    tok: Any
    pos: Any
    rem: Any
    taken: Any
    stops: Any
    temp: Any
    top_k: Any
    top_p: Any
    keys: Any


def make_block_decode(api: "ModelAPI", n: int, policy=None,
                      sample: bool = False, tracer=None,
                      fused: bool = False) -> Callable:
    """``n`` decode steps with on-device token selection:
    ``fn(params, carry, state) -> (tokens (n, B) int32, carry, state)``.

    Slots whose budget is spent feed the pad token at their own current
    position (never position 0, which may hold live prompt context of a
    slot still mid-prefill) and stop advancing. A selected token in the
    slot's ``stops`` zeroes its budget on the device (EOS stopping).
    ``fused=True`` runs every step under the 'fused' executor variant;
    otherwise fake-quant projections are staged once for the block
    (``quant.prepare.stage_params``). ``tracer`` marks the first call of
    each program with an instant, as the reference marks each trace."""
    if not block_decode_eligible(api.cfg):
        raise ValueError(
            f"family {api.cfg.family!r} is not eligible for blocked decode "
            f"(want one of {_BLOCK_DECODE_FAMILIES})")
    if policy is None:
        from repro_torch.core.policy import get_policy
        policy = get_policy(api.cfg.precision_policy)
    first = [True]

    def run(params, carry: DecodeCarry, state):
        from repro_torch.layers.mplinear import executor_variant
        from repro_torch.models.sampling import sample_tokens
        from repro_torch.quant.prepare import stage_params
        if tracer is not None and first[0]:
            tracer.instant(f"first_call:block_decode[n={n}]", cat="compile")
        first[0] = False
        variant = contextlib.nullcontext()
        if fused:
            variant = executor_variant("fused")
        else:
            params = stage_params(params, policy, projection_paths(api.cfg))
        c = carry
        tok, pos, rem, taken, keys = c.tok, c.pos, c.rem, c.taken, c.keys
        out = []
        with variant:
            for _ in range(n):
                active = rem > 0
                batch = {"token": torch.where(active, tok,
                                              torch.zeros_like(tok))[:, None],
                         "pos": pos}
                logits, state = api.decode_step(params, batch, state)
                if sample:
                    keys2, nxt = sample_tokens(keys, logits, c.temp, c.top_k,
                                               c.top_p)
                    keys = torch.where(active[:, None], keys2, keys)
                else:
                    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                hit = (nxt[:, None] == c.stops).any(dim=-1) & active
                tok = torch.where(active, nxt, tok)
                pos = torch.where(active, pos + 1, pos)
                rem = torch.where(active, torch.where(hit, 0, rem - 1), rem)
                taken = taken + active.to(torch.int32)
                out.append(nxt)
        return (torch.stack(out),
                c._replace(tok=tok, pos=pos, rem=rem, taken=taken,
                           keys=keys),
                state)

    return run


class ModelAPI(NamedTuple):
    cfg: ModelConfig
    init: Callable            # init(seed=0, device=None, draws="torch")
    loss_fn: Callable         # loss_fn(params, batch) -> (loss, metrics)
    prefill: Callable
    decode_step: Callable
    init_cache: Callable      # init_cache(batch, max_len, device=None)
    prepare: Callable = None
    prefill_chunk: Callable = None


# the families ``build`` serves, each by its module's init /
# hidden_states + head (training) / prefill / decode_step / init_cache
_FAMILY_MODULES = {"lm": lm, "vlm": vlm, "rwkv": rwkv, "griffin": griffin,
                   "encdec": encdec}
# the batch entries a family's prefill and hidden_states take after the
# tokens
_EXTRA_INPUTS = {"vlm": ("patches",), "encdec": ("frames",)}


def _loss_fn(mod, cfg: ModelConfig, extras) -> Callable:
    """``loss_fn(params, batch)`` of a family: ``batch["tokens"]`` (B,
    S + 1) -> (mean next-token nats + 0.01 aux, {"nll", "aux"}) over the
    positions ``batch["mask"]`` keeps (optional, (B, S + 1); the
    reference's vlm and encdec take none). aux is the MoE load-balancing
    loss, 0 without experts. The head and loss run fused over chunks
    (``losses.fused_chunked_xent``): the (B, S, V) logits never exist."""
    def loss_fn(params, batch):
        tokens = batch["tokens"]
        x, aux = mod.hidden_states(params, cfg, tokens[:, :-1],
                                   *(batch[k] for k in extras))
        mask = batch.get("mask")
        loss, m = fused_chunked_xent(
            x, lambda xc: mod.head(params, cfg, xc), tokens[:, 1:],
            mask[:, 1:] if mask is not None else None)
        return loss + 0.01 * aux, {**m, "aux": aux}

    return loss_fn


def build(cfg: ModelConfig) -> ModelAPI:
    mod = _FAMILY_MODULES[cfg.family]
    extras = _EXTRA_INPUTS.get(cfg.family, ())

    def prefill(p, batch, caches):
        return mod.prefill(p, cfg, batch["tokens"], caches,
                           *(batch[k] for k in extras))

    # vlm's caches also hold the patch embeddings it prefills
    extra = (cfg.n_patches or 0) if cfg.family == "vlm" else 0
    chunk = None
    if cfg.family == "lm":
        def chunk(p, batch, caches):
            return lm.prefill_chunk(p, cfg, batch["tokens"], batch["offsets"],
                                    batch["lengths"], caches)
    return ModelAPI(
        cfg,
        lambda seed=0, device=None, draws="torch": mod.init(
            cfg, seed, device, draws),
        _loss_fn(mod, cfg, extras),
        prefill,
        lambda p, batch, caches: mod.decode_step(
            p, cfg, batch["token"], batch["pos"], caches),
        lambda bsz, max_len, device=None: mod.init_cache(
            cfg, bsz, max_len + extra, device),
        _prepare_fn(cfg),
        chunk,
    )


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Seeded random parameters for ``cfg`` on ``device`` (CUDA by
    default; raises without CUDA unless ``device="cpu"``)."""
    return build(cfg).init(seed, device)


def calibration_batch(cfg: ModelConfig, batch: int, seq_len: int,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """A prefill batch from a numpy seed — the port's counterpart of
    ``materialize_batch`` for calibration (the reference draws with
    jax.random, which torch cannot repeat): ``tokens`` (batch, seq_len)
    int32 and, for vlm, ``patches`` (batch, n_patches, vit_dim), for
    encdec ``frames`` (batch, seq_len // 4, frontend_dim), both f32
    standard normal (``materialize_batch``'s prefill batch, in numpy)."""
    shape = InputShape("calibration", seq_len, batch, "prefill")
    return {k: v.numpy() for k, v in
            materialize_batch(cfg, shape, seed, device="cpu").items()}


class Spec(NamedTuple):
    """One batch entry's shape and dtype (no storage)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Spec]:
    """The batch of a step kind for (arch x shape): "train" takes
    ``tokens`` (B, S + 1), "prefill" ``tokens`` (B, S), both with encdec
    ``frames`` (B, S // 4, frontend_dim) or vlm ``patches`` (B,
    n_patches, vit_dim) in f32; "decode" ``token`` (B, 1) and ``pos``
    (B,)."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": Spec((b, s + 1 if shape.kind == "train" else s),
                                i32)}
        if cfg.family == "encdec":
            batch["frames"] = Spec((b, s // 4, cfg.frontend_dim), f32)
        if cfg.family == "vlm":
            batch["patches"] = Spec((b, cfg.n_patches, cfg.vit_dim), f32)
        return batch
    if shape.kind == "decode":
        return {"token": Spec((b, 1), i32), "pos": Spec((b,), i32)}
    raise ValueError(shape.kind)


def materialize_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
                      device=None) -> Dict[str, torch.Tensor]:
    """A random batch matching ``input_specs`` on ``device`` (CUDA by
    default), drawn from ``np.random.default_rng(seed)`` in spec order:
    tokens uniform in [0, min(vocab, 1000)), ``pos`` seq_len - 1, float
    entries standard normal (the reference's distributions; it draws
    with jax.random)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if name == "pos":
            a = np.full(spec.shape, shape.seq_len - 1, np.int32)
        elif spec.dtype == torch.int32:
            a = rng.integers(0, min(cfg.vocab, 1000), spec.shape,
                             dtype=np.int32)
        else:
            a = rng.standard_normal(spec.shape, dtype=np.float32)
        out[name] = torch.from_numpy(a).to(device)
    return out
