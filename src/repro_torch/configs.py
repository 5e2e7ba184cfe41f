"""Model configuration: the port's own copy of ``repro.configs``.

``ModelConfig``/``MoESpec``/``InputShape`` mirror ``repro/configs/base.py``
field for field; ``get_config`` knows the architectures this port serves
(``repro/configs/<arch>.py``): the ``lm`` family (qwen2-0.5b,
gemma2-9b, glm4-9b, stablelm-12b, mixtral-8x7b and qwen3-moe-30b-a3b),
internvl2-1b (``vlm``), rwkv6-1.6b (``rwkv``), recurrentgemma-9b
(``griffin``) and seamless-m4t-medium (``encdec``); and ``reduced`` repeats
``repro/configs/__init__.py::reduced`` (the family-preserving tiny
variant the CPU tests run).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    dispatch: str = "einsum"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. ``family`` selects the model implementation:
    'lm' (dense and MoE), 'vlm', 'rwkv', 'griffin' or 'encdec'."""

    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "silu"
    norm: str = "rms"
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    attn_pattern: str = "full"
    window: Optional[int] = None
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    post_norms: bool = False
    tied_embeddings: bool = True
    attn_scale: Optional[float] = None
    moe: Optional[MoESpec] = None
    d_rnn: Optional[int] = None
    conv_width: int = 4
    rec_pattern: Tuple[str, ...] = ()
    n_enc_layers: Optional[int] = None
    frontend_dim: Optional[int] = None
    n_patches: Optional[int] = None
    vit_dim: Optional[int] = None
    precision_policy: str = "bf16"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 64 (the extra logit
        columns are masked in the head)."""
        return -(-self.vocab // 64) * 64

    @property
    def sub_quadratic(self) -> bool:
        """Bounded state/window per token -> long_500k-capable."""
        if self.family in ("rwkv", "griffin"):
            return True
        return self.attn_pattern == "swa" and self.window is not None

    def params_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, hd = self.d_model, self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.moe:
            ffn = 3 * d * self.moe.d_expert * self.moe.n_experts \
                + d * self.moe.n_experts
        else:
            ffn = 3 * d * self.d_ff
        layers = self.n_layers * (attn + ffn)
        emb = self.vocab * d * (1 if self.tied_embeddings else 2)
        return layers + emb


    def active_params_count(self) -> int:
        if not self.moe:
            return self.params_count()
        d = self.d_model
        hd = self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        ffn = 3 * d * self.moe.d_expert * self.moe.top_k
        return self.n_layers * (attn + ffn) + self.vocab * d


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str


# the production cells' input shapes (the reference's ``SHAPES``)
SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k needs sub-quadratic attention (assignment rule)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def qwen2_0_5b() -> ModelConfig:
    """Qwen2-0.5B [arXiv:2407.10671; hf:Qwen/Qwen2-0.5B]: 24L, d_model
    896, 14 heads (GQA kv=2, head_dim 64), d_ff 4864, vocab 151936, QKV
    bias, RMSNorm, SwiGLU, tied embeddings, rope 1e6."""
    return ModelConfig(
        arch_id="qwen2-0.5b", family="lm", n_layers=24, d_model=896,
        n_heads=14, n_kv_heads=2, head_dim=64, d_ff=4864, vocab=151936,
        qkv_bias=True, norm="rms", act="silu", rope_theta=1e6,
        attn_pattern="full", tied_embeddings=True)


def gemma2_9b() -> ModelConfig:
    """Gemma-2 9B [arXiv:2408.00118; hf:google/gemma-2-9b]: 42L, d_model
    3584, 16 heads (GQA kv=8, head_dim 256), d_ff 14336, vocab 256000.
    Alternating local(4096)/global attention, logit softcap 30, attention
    softcap 50, GeGLU, zero-centered RMSNorm with pre+post block norms,
    query scale 1/sqrt(256), tied embeddings."""
    return ModelConfig(
        arch_id="gemma2-9b", family="lm", n_layers=42, d_model=3584,
        n_heads=16, n_kv_heads=8, head_dim=256, d_ff=14336, vocab=256000,
        norm="rms_zc", act="gelu_tanh", attn_pattern="alt_local_global",
        window=4096, logit_softcap=30.0, attn_softcap=50.0,
        post_norms=True,
        attn_scale=0.0625,  # 1/sqrt(query_pre_attn_scalar=256)
        tied_embeddings=True)


def glm4_9b() -> ModelConfig:
    """GLM-4 9B [hf:THUDM/glm-4-9b]: 40L, d_model 4096, 32 heads (GQA
    kv=2, head_dim 128), d_ff 13696, vocab 151552. QKV bias, partial
    rotary (50%, GLM 2D RoPE approximated as half-rotary), RMSNorm,
    SwiGLU, untied."""
    return ModelConfig(
        arch_id="glm4-9b", family="lm", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=2, head_dim=128, d_ff=13696, vocab=151552,
        qkv_bias=True, norm="rms", act="silu", rotary_pct=0.5,
        attn_pattern="full", tied_embeddings=False)


def stablelm_12b() -> ModelConfig:
    """StableLM-2 12B [hf:stabilityai/stablelm-2-12b; arXiv:2402.17834]:
    40L, d_model 5120, 32 heads (GQA kv=8, head_dim 160), d_ff 13824,
    vocab 100352. LayerNorm, partial rotary (25%), SwiGLU, untied."""
    return ModelConfig(
        arch_id="stablelm-12b", family="lm", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, head_dim=160, d_ff=13824, vocab=100352,
        norm="ln", act="silu", rotary_pct=0.25, attn_pattern="full",
        tied_embeddings=False)


def mixtral_8x7b() -> ModelConfig:
    """Mixtral 8x7B [arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1]:
    32L, d_model 4096, 32 heads (GQA kv=8, head_dim 128), vocab 32000,
    MoE: 8 experts, top-2, d_expert 14336. Sliding-window attention
    (4096) bounds the KV cache."""
    return ModelConfig(
        arch_id="mixtral-8x7b", family="lm", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000,
        norm="rms", act="silu", rope_theta=1e6, attn_pattern="swa",
        window=4096, moe=MoESpec(n_experts=8, top_k=2, d_expert=14336),
        tied_embeddings=False)


def qwen3_moe_30b_a3b() -> ModelConfig:
    """Qwen3-MoE 30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L, d_model 2048, 32
    heads (GQA kv=4, head_dim 128), vocab 151936, MoE: 128 experts,
    top-8, d_expert 768. QK-norm, no QKV bias, full attention, rope
    1e6."""
    return ModelConfig(
        arch_id="qwen3-moe-30b-a3b", family="lm", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768, vocab=151936,
        norm="rms", act="silu", qk_norm=True, rope_theta=1e6,
        attn_pattern="full",
        moe=MoESpec(n_experts=128, top_k=8, d_expert=768),
        tied_embeddings=False)


def internvl2_1b() -> ModelConfig:
    """InternVL2-1B [arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B]:
    Qwen2-0.5B language backbone (24L, d_model 896, 14 heads GQA kv=2,
    d_ff 4864, vocab 151655) + InternViT stub frontend: precomputed patch
    embeddings (256 tokens after pixel-shuffle, dim 1024) mapped through
    a 2-layer MLP projector."""
    return ModelConfig(
        arch_id="internvl2-1b", family="vlm", n_layers=24, d_model=896,
        n_heads=14, n_kv_heads=2, head_dim=64, d_ff=4864, vocab=151655,
        qkv_bias=True, norm="rms", act="silu", rope_theta=1e6,
        attn_pattern="full", tied_embeddings=True, n_patches=256,
        vit_dim=1024)


def rwkv6_1_6b() -> ModelConfig:
    """RWKV-6 "Finch" 1.6B [arXiv:2404.05892]: 24L, d_model 2048,
    attention-free (32 heads of size 64 in the wkv state), d_ff 7168,
    vocab 65536. Data-dependent decay via LoRA; LayerNorm;
    sub-quadratic."""
    return ModelConfig(
        arch_id="rwkv6-1.6b", family="rwkv", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536, norm="ln",
        tied_embeddings=False)


def recurrentgemma_9b() -> ModelConfig:
    """RecurrentGemma-9B (Griffin) [arXiv:2402.19427]: 38L, d_model 4096,
    RG-LRU recurrence + local attention 1:2 (rec, rec, attn triples; 2
    trailing rec), 16 heads MQA (kv=1, head_dim 256), d_ff 12288, d_rnn
    4096, window 2048, vocab 256000. Gemma-style zero-centered RMSNorm +
    GeGLU. Sub-quadratic."""
    return ModelConfig(
        arch_id="recurrentgemma-9b", family="griffin", n_layers=38,
        d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288,
        vocab=256000, norm="rms_zc", act="gelu_tanh", attn_pattern="swa",
        window=2048, d_rnn=4096, conv_width=4,
        rec_pattern=("rec", "rec", "attn"), tied_embeddings=True)


def seamless_m4t_medium() -> ModelConfig:
    """SeamlessM4T-medium backbone [arXiv:2308.11596]: 12 encoder + 12
    decoder layers, d_model 1024, 16 heads (MHA, head_dim 64), d_ff
    4096, vocab 256206, LayerNorm, GeLU, untied. The speech frontend is
    a stub: precomputed frame embeddings (seq/4 frames of dim 160) enter
    through a linear projector; self-attention positions use RoPE."""
    return ModelConfig(
        arch_id="seamless-m4t-medium", family="encdec", n_layers=12,
        n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        head_dim=64, d_ff=4096, vocab=256206, norm="ln", act="gelu",
        frontend_dim=160, attn_pattern="full", tied_embeddings=False)


_CONFIGS = {"qwen2-0.5b": qwen2_0_5b, "gemma2-9b": gemma2_9b,
            "glm4-9b": glm4_9b, "stablelm-12b": stablelm_12b,
            "mixtral-8x7b": mixtral_8x7b,
            "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
            "internvl2-1b": internvl2_1b, "rwkv6-1.6b": rwkv6_1_6b,
            "recurrentgemma-9b": recurrentgemma_9b,
            "seamless-m4t-medium": seamless_m4t_medium}
ARCH_IDS = tuple(_CONFIGS)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _CONFIGS[arch_id]()
    except KeyError:
        raise KeyError(f"{arch_id!r} is not ported yet "
                       f"(ported: {ARCH_IDS})") from None


def reduced(arch_id: str) -> ModelConfig:
    """Family-preserving tiny config for CPU tests (same rules as the
    reference's ``reduced``)."""
    cfg = get_config(arch_id)
    kv = max(1, min(cfg.n_kv_heads, 2))
    moe = None
    if cfg.moe:
        moe = MoESpec(n_experts=min(cfg.moe.n_experts, 4),
                      top_k=min(cfg.moe.top_k, 2), d_expert=32,
                      capacity_factor=2.0)
    n_layers = {"lm": 2, "rwkv": 2, "vlm": 2, "encdec": 2,
                "griffin": 5}[cfg.family]
    if cfg.attn_pattern == "alt_local_global":
        n_layers = 2
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=64, n_heads=4, n_kv_heads=kv,
        head_dim=16, d_ff=128, vocab=512, moe=moe,
        d_rnn=64 if cfg.d_rnn else None,
        window=min(cfg.window, 16) if cfg.window else None,
        n_enc_layers=2 if cfg.n_enc_layers else None,
        frontend_dim=16 if cfg.frontend_dim else None,
        n_patches=8 if cfg.n_patches else None,
        vit_dim=32 if cfg.vit_dim else None,
        remat="none")
