"""Ahead-of-time weight preparation (mirror of ``repro/quant/prepare.py``).

``prepare_params`` walks a parameter tree once and, per
``PrecisionSpec``, replaces each projection's fp32 ``w`` with a
:class:`PreparedWeight` in its storage format: int8 rows, nibble-packed
int4, fp8 e4m3 codes, nibble-packed fp4 e2m1 codes (per-channel or
per-group scales), fp16 for ``fp16_ipu``; bf16/fp32 stay raw. Every leaf
keeps the stacked leading layer axis; quantization reduces over axis -2,
the contraction dim. ``dequant`` reproduces the dynamic fake-quant value
bit-exactly (the same ``q * scale`` on the same ``q``/``scale``).

The staged kinds (``stage_params``) exist only inside one blocked decode
dispatch when the fused executors are off; they never live in engine
storage. ``tree_manifest`` / ``tree_from_manifest`` are the
self-describing checkpoint codec (``repro_torch.checkpoint``): the same
tree gives the same spec and leaf order as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.core.policy import PrecisionPolicy, PrecisionSpec
from repro_torch.quant.quantize import (FP4_E2M1, FP8_E4M3, fp_decode,
                                        fp_quantize, quantize_symmetric)

MODE_BYTES_PER_PARAM = {
    "fp32": 4.0, "bf16": 2.0, "fp16_ipu": 2.0, "int8": 1.0, "int4": 0.5,
    "fp8": 1.0, "fp4": 0.5,
}

_STAGED_KIND = {
    "int8": "staged8", "int4": "staged4", "int4_packed": "staged4",
    "fp8": "staged_fp8", "fp4": "staged_fp4", "fp4_packed": "staged_fp4",
}
_FP_KINDS = ("fp8", "fp4", "fp4_packed")
_FP_FMT = {"fp8": FP8_E4M3, "fp4": FP4_E2M1, "fp4_packed": FP4_E2M1}


@dataclasses.dataclass(frozen=True)
class PreparedWeight:
    """One projection weight in its deployment storage format.

    ``kind``: 'int8' | 'int4' (int8-storage nibble values) |
    'int4_packed' | 'fp8' (uint8 e4m3 codes) | 'fp4' (e2m1 codes, low
    nibble) | 'fp4_packed' | 'fp16', or a staged kind ('staged8',
    'staged4', 'staged_fp8', 'staged_fp4': dequantized compute-dtype
    data). ``scale``: f32 (..., G, N), G scale groups along the
    contraction dim (G == 1 per-channel). ``act_scale``: the calibrated
    static activation scale, one 0-d f32 per stacked layer.
    """

    data: torch.Tensor
    scale: Optional[torch.Tensor] = None
    kind: str = "int8"
    act_scale: Optional[torch.Tensor] = None

    @property
    def weight_bits(self) -> Optional[int]:
        return {"int8": 8, "int4": 4, "int4_packed": 4,
                "staged8": 8, "staged4": 4}.get(self.kind)

    @property
    def staged(self) -> bool:
        return self.kind in ("staged8", "staged4", "staged_fp8",
                             "staged_fp4")

    @property
    def scale_groups(self) -> int:
        return 1 if self.scale is None else int(self.scale.shape[-2])

    def index(self, i: int) -> "PreparedWeight":
        """The container of stacked layer ``i`` (views, no copy)."""
        return PreparedWeight(
            self.data[i], None if self.scale is None else self.scale[i],
            self.kind, None if self.act_scale is None else self.act_scale[i])

    def unpacked(self) -> torch.Tensor:
        from repro_torch.kernels import ops as kops
        if self.kind == "int4_packed":
            return kops.unpack_int4(self.data)
        if self.kind == "fp4_packed":
            return kops.unpack_u4(self.data)
        return self.data

    def dequant(self) -> torch.Tensor:
        """f32 weights, bit-exact to the dynamic fake-quant value."""
        if self.kind == "fp16" or self.staged:
            return self.data.to(torch.float32)
        q = self.unpacked()
        if self.kind in _FP_KINDS:
            vals = fp_decode(q, _FP_FMT[self.kind])
        else:
            vals = q.to(torch.float32)
        groups = self.scale_groups
        if groups == 1:
            return vals * self.scale
        k, n = vals.shape[-2:]
        out = (vals.reshape(*vals.shape[:-2], groups, k // groups, n)
               * self.scale[..., :, None, :])
        return out.reshape(vals.shape)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.data, self.scale, self.act_scale)
                   if t is not None)


def _resolved_groups(k: int, spec: PrecisionSpec) -> int:
    g = getattr(spec, "group_size", None)
    if g and k % g == 0 and k // g > 1:
        return k // g
    return 1


def _quantize_spec(w: torch.Tensor, spec: PrecisionSpec):
    wf = w.to(torch.float32)
    k, n = w.shape[-2:]
    groups = _resolved_groups(k, spec)
    if groups > 1:
        wf = wf.reshape(*w.shape[:-2], groups, k // groups, n)
    if spec.mode in ("fp8", "fp4"):
        fmt = FP8_E4M3 if spec.mode == "fp8" else FP4_E2M1
        q, s = fp_quantize(wf, fmt, axis=-2)
    else:
        q, s = quantize_symmetric(wf, spec.weight_bits, axis=-2)
    if groups > 1:
        q = q.reshape(*w.shape[:-2], k, n)
        s = s.squeeze(-2)
    return q, s


def prepare_weight(w, spec: PrecisionSpec, act_scale: Optional[float] = None):
    """Prepare ONE weight tensor (..., d_in, d_out) for ``spec``."""
    if isinstance(w, PreparedWeight):
        return w
    if spec.mode in ("bf16", "fp32"):
        return w
    if spec.mode == "fp16_ipu":
        return PreparedWeight(w.to(torch.float16), None, "fp16")
    from repro_torch.layers.mplinear import note_weight_quant
    note_weight_quant()
    a = None if act_scale is None else torch.full(
        w.shape[:-2], act_scale, dtype=torch.float32, device=w.device)
    if w.dim() > 2:
        # a stacked leaf one leading index at a time: each slice
        # quantizes alone along -2, so the codes and scales are the
        # whole stack's, and the temporaries are one slice's (a stacked
        # qwen3-moe expert leaf holds 12.9 GB of f32)
        parts = [_storage(wi, spec) for wi in w]
        data = torch.stack([d for d, _, _ in parts])
        scale = torch.stack([sc for _, sc, _ in parts])
        return PreparedWeight(data, scale, parts[0][2], a)
    return PreparedWeight(*_storage(w, spec), a)


def _storage(w: torch.Tensor, spec: PrecisionSpec):
    """(stored data, scales, kind) of one weight (..., d_in, d_out)."""
    from repro_torch.kernels import ops as kops
    q, s = _quantize_spec(w, spec)
    even_k = w.shape[-2] % 2 == 0
    if spec.mode == "fp8":
        return q, s, "fp8"
    if spec.mode == "fp4":
        return (kops.pack_u4(q), s, "fp4_packed") if even_k \
            else (q, s, "fp4")
    if spec.weight_bits == 4 and even_k:
        return kops.pack_int4(q), s, "int4_packed"
    return q, s, "int8" if spec.weight_bits == 8 else "int4"


PathResolver = Union[Callable[[str], Optional[str]], Mapping[str, str]]


def _resolver(paths: PathResolver) -> Callable[[str], Optional[str]]:
    return paths if callable(paths) else paths.get


def _is_weight(v) -> bool:
    return isinstance(v, (torch.Tensor, PreparedWeight))


def _map_projections(params, resolve, fn: Callable[[str, Any], Any]):
    """Rebuild ``params`` with ``fn(container_path, weight)`` applied to
    every projection 'w' leaf ``resolve`` targets; the rest passes
    through by reference."""
    def walk(node, prefix: str):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                child = f"{prefix}/{k}" if prefix else k
                if k == "w" and _is_weight(v) and resolve(prefix) is not None:
                    out[k] = fn(prefix, v)
                else:
                    out[k] = walk(v, child)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(
                walk(v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(node))
        return node

    return walk(params, "")


def prepare_params(params, policy: PrecisionPolicy, paths: PathResolver,
                   act_scales: Optional[Mapping[str, float]] = None):
    """Prepare every projection weight of ``params`` (pure: returns a new
    tree, untouched leaves by reference). ``paths`` maps a container
    path ('blocks/b0/attn/wq') to its policy path ('block/full/attn/wq')
    or None; ``act_scales`` (policy path -> calibrated static scale)
    rides onto each int container it covers."""
    resolve = _resolver(paths)

    def prep(prefix: str, w):
        pol_path = resolve(prefix)
        a = act_scales.get(pol_path) if act_scales is not None else None
        return prepare_weight(w, policy.spec_for(pol_path), act_scale=a)

    return _map_projections(params, resolve, prep)


_STAGED_COUNT: Optional[List[int]] = None


@contextlib.contextmanager
def count_staged():
    """Count staged compute-dtype operand materializations while open."""
    global _STAGED_COUNT
    prev = _STAGED_COUNT
    box = [0]
    _STAGED_COUNT = box
    try:
        yield box
    finally:
        _STAGED_COUNT = prev


def note_staged(n: int = 1):
    if _STAGED_COUNT is not None:
        _STAGED_COUNT[0] += n


def stage_params(params, policy: PrecisionPolicy, paths: PathResolver,
                 compute_dtype=torch.bfloat16):
    """Stage every fake-quant projection once for a blocked decode
    dispatch (the fallback when the fused executors are off): quantized
    containers of non-exact specs become staged containers holding
    ``dequant().to(compute_dtype)``, and bf16-routed raw weights are cast
    once. Exact-kernel and fp16 specs pass through."""
    resolve = _resolver(paths)

    def stage(prefix: str, w):
        spec = policy.spec_for(resolve(prefix))
        if spec.exact:
            return w
        if isinstance(w, PreparedWeight):
            staged_kind = _STAGED_KIND.get(w.kind)
            if staged_kind is not None and not w.staged:
                note_staged()
                return PreparedWeight(w.dequant().to(compute_dtype), None,
                                      staged_kind, w.act_scale)
            return w
        if spec.mode == "bf16":
            return w.to(compute_dtype)
        return w

    return _map_projections(params, resolve, stage)


# ---------------------------------------------------------------------------
# tree <-> manifest: the self-describing checkpoint codec
#
# A PreparedWeight tree cannot restore through a template cast (a cast
# would destroy packed nibbles), so the spec records containers,
# PreparedWeight kinds and the leaf order explicitly. The order is the
# reference's (jax's flattening order): sorted dict keys, sequence order,
# then data, scale, act_scale with None fields skipped.

def tree_manifest(tree) -> Tuple[Any, list]:
    """Encode ``tree`` into a msgpack-able structure spec + flat leaves.

    Handles dicts, lists, tuples, ``None`` and :class:`PreparedWeight`
    containers; everything else is a leaf. The inverse is
    :func:`tree_from_manifest`.
    """
    leaves: list = []

    def ref(x) -> int:
        leaves.append(x)
        return len(leaves) - 1

    def enc(node):
        if node is None:
            return {"t": "none"}
        if isinstance(node, PreparedWeight):
            return {"t": "prepared", "kind": node.kind,
                    "data": ref(node.data),
                    "scale": None if node.scale is None
                    else ref(node.scale),
                    "act_scale": None if node.act_scale is None
                    else ref(node.act_scale)}
        if isinstance(node, dict):
            return {"t": "dict",
                    "keys": sorted(node),
                    "items": [enc(node[k]) for k in sorted(node)]}
        if isinstance(node, (list, tuple)):
            return {"t": "list" if isinstance(node, list) else "tuple",
                    "items": [enc(v) for v in node]}
        return {"t": "leaf", "i": ref(node)}

    return enc(tree), leaves


def tree_from_manifest(spec, leaves: Sequence[Any], like=None):
    """Rebuild the tree :func:`tree_manifest` encoded, consuming restored
    leaves (exact dtypes: no template, no cast). The spec spells every
    tuple alike; given ``like`` (a tree of the same structure), each
    tuple that ``like`` holds as a NamedTuple comes back as that
    NamedTuple."""

    def dec(s, lk):
        t = s["t"]
        if t == "none":
            return None
        if t == "prepared":
            return PreparedWeight(
                leaves[s["data"]],
                None if s["scale"] is None else leaves[s["scale"]],
                s["kind"],
                None if s["act_scale"] is None
                else leaves[s["act_scale"]])
        if t == "dict":
            return {k: dec(v, None if lk is None else lk[k])
                    for k, v in zip(s["keys"], s["items"])}
        if t in ("list", "tuple"):
            items = [dec(v, None if lk is None else lk[i])
                     for i, v in enumerate(s["items"])]
            if t == "list":
                return items
            if isinstance(lk, tuple) and hasattr(lk, "_fields"):
                return type(lk)(*items)
            return tuple(items)
        if t == "leaf":
            return leaves[s["i"]]
        raise ValueError(f"unknown tree-spec node type {t!r}")

    return dec(spec, like)


def iter_projection_weights(params, paths: PathResolver):
    """Yield (container_path, weight_leaf) for every targeted projection."""
    resolve = _resolver(paths)

    def walk(node, prefix: str):
        if isinstance(node, dict):
            for k, v in node.items():
                child = f"{prefix}/{k}" if prefix else k
                if k == "w" and _is_weight(v) and resolve(prefix) is not None:
                    yield prefix, v
                else:
                    yield from walk(v, child)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(v, f"{prefix}/{i}" if prefix else str(i))

    yield from walk(params, "")


def tree_leaves(tree) -> List[Any]:
    """Leaves of a dict/list/tuple tree; PreparedWeight counts as one."""
    if isinstance(tree, dict):
        return [lf for v in tree.values() for lf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [lf for v in tree for lf in tree_leaves(v)]
    return [tree]


def _leaf_bytes(leaf: Any) -> int:
    if isinstance(leaf, PreparedWeight):
        return leaf.nbytes()
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return 0


def weight_resident_bytes(params, paths: Optional[PathResolver] = None,
                          by_kind: bool = True) -> Dict[str, Any]:
    """{'total': bytes of every leaf, 'projections': bytes of the
    policy-routed projections (given ``paths``), 'by_kind': projection
    bytes per storage kind ('raw' = unprepared tensors)}."""
    out: Dict[str, Any] = {
        "total": int(sum(_leaf_bytes(lf) for lf in tree_leaves(params)))}
    if paths is not None:
        kinds: Dict[str, int] = {}
        proj = 0
        for _, w in iter_projection_weights(params, paths):
            b = _leaf_bytes(w)
            kind = w.kind if isinstance(w, PreparedWeight) else "raw"
            kinds[kind] = kinds.get(kind, 0) + b
            proj += b
        out["projections"] = int(proj)
        if by_kind:
            out["by_kind"] = kinds
    return out
