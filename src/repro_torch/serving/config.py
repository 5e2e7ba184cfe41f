"""Serving configuration surfaces: ``EngineConfig`` + ``SamplingParams``
(the port's copy of ``repro/serving/config.py``).

The serving API separates three concerns (FlexiBit's lesson in
PAPERS.md — keep the precision ladder orthogonal to the control plane):

* **plan/policy** — ``ModelConfig.precision_policy`` (a preset name or
  ``plan:<file>`` artifact), owned by the model config;
* **engine tuning** — :class:`EngineConfig`, one frozen dataclass
  validated at construction, passed as ``ServingEngine(cfg, api,
  params, config=EngineConfig(...))``;
* **per-request sampling** — :class:`SamplingParams` on each
  ``Request`` (temperature/top-k/top-p/stop ids/budget/seed); greedy is
  ``SamplingParams(temperature=0.0)``, the default.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

# stop-id slots carried per decode slot in the blocked decode carry
# (fixed so the blocked program's shape never depends on a request)
MAX_STOP_IDS = 4

_PREFILL_MODES = ("auto", "batched", "teacher")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-level tuning knobs of a :class:`~repro_torch.serving.engine.
    ServingEngine`, validated at construction.

    ``mid_block_admission`` lets the engine cut decode blocks short
    when requests are queued (block boundaries chosen by queue depth
    and the nearest completion, floored at half the configured block so
    the extra host syncs stay bounded), so a freed slot admits after
    roughly half a block instead of a full one.
    ``eos_stopping`` honours per-request stop ids (plus the engine-wide
    ``eos_id``) inside the decode block, freeing slots and budget
    mid-block. Turning both off gives the between-block engine, the
    ablation baseline.

    ``fused_executors`` selects the fused kernel datapath
    (``kernels.fused`` via ``layers.mplinear.executor_variant``):
    ``"on"`` traces every engine program under the 'fused' variant and
    skips the per-block staging walk (no staged compute-dtype operand is
    ever materialized); ``"off"`` keeps the staged path; ``"auto"``
    (default) turns it on exactly when the engine prepared weights and
    resolved calibrated activation scales — the operands the fused
    kernels need.

    ``prefill`` is the admission mode: ``"batched"`` takes the chunked
    prefill waves (the lm family alone has them; other families raise),
    ``"teacher"`` feeds each prompt token through one decode step, and
    ``"auto"`` takes the chunked waves for lm and teacher forcing for
    every other family.

    Observability (``repro_torch.obs``): ``trace=True`` records request
    lifecycle + tick-phase + compile spans on the engine's
    :class:`~repro_torch.obs.Tracer` (``engine.dump_trace(path)`` exports
    Chrome trace-event JSON; tracing off costs nothing).
    ``cost_correction`` declares how a router should cost this replica:
    ``"static"`` keeps the simulator estimate, ``"online"`` blends in
    the measured :class:`~repro_torch.obs.ReplicaStats` (EWMA tok/s over
    per-tick samples with weight ``stats_alpha``; TTFT p95 and rolling
    gauges over the last ``stats_window`` samples).
    """

    batch_slots: int = 4
    cache_len: int = 512
    prefill: str = "auto"              # auto | batched | teacher
    prefill_chunk: int = 32            # prompt tokens per prefill wave
    decode_block: int = 1              # decode steps per host dispatch
    prepare_weights: bool = True
    act_calibration: Any = None        # None | {path: scale} | "auto"
    fused_executors: str = "auto"      # auto | on | off
    mid_block_admission: bool = True
    eos_stopping: bool = True
    eos_id: Optional[int] = None       # engine-wide stop id (e.g. <eos>)
    seed: int = 0                      # base PRNG seed for sampling
    trace: bool = False                # record spans (obs.Tracer)
    cost_correction: str = "static"    # static | online (router costing)
    stats_window: int = 64             # rolling gauge / TTFT window
    stats_alpha: float = 0.2           # EWMA weight of newest rate sample

    def __post_init__(self):
        if self.batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got "
                             f"{self.batch_slots}")
        if self.cache_len < 1:
            raise ValueError(f"cache_len must be >= 1, got "
                             f"{self.cache_len}")
        if self.prefill not in _PREFILL_MODES:
            raise ValueError(f"prefill mode {self.prefill!r} "
                             f"(want one of {_PREFILL_MODES})")
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{self.prefill_chunk}")
        if self.decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got "
                             f"{self.decode_block}")
        if self.fused_executors not in ("auto", "on", "off"):
            raise ValueError(
                f"fused_executors must be 'auto', 'on' or 'off', got "
                f"{self.fused_executors!r}")
        if self.eos_id is not None and self.eos_id < 0:
            raise ValueError(f"eos_id must be a token id, got "
                             f"{self.eos_id}")
        if self.cost_correction not in ("static", "online"):
            raise ValueError(
                f"cost_correction must be 'static' or 'online', got "
                f"{self.cost_correction!r}")
        if self.stats_window < 1:
            raise ValueError(f"stats_window must be >= 1, got "
                             f"{self.stats_window}")
        if not 0.0 < self.stats_alpha <= 1.0:
            raise ValueError(f"stats_alpha must be in (0, 1], got "
                             f"{self.stats_alpha}")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters (vLLM-shaped), carried on
    ``Request.sampling``.

    ``temperature <= 0`` selects greedy argmax (the default);
    ``top_k=0`` / ``top_p=1.0`` leave the distribution unrestricted.
    ``stop_ids`` end the stream as soon as one is generated (the stop
    token is kept in the output); ``max_new_tokens`` overrides the
    request-level budget when set. ``seed`` pins the request's PRNG key
    — otherwise the key derives from the engine seed and the request id
    (``models.sampling.make_key``), so sampled streams are reproducible regardless of
    slot placement, co-resident requests, or ``decode_block``.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_ids: Tuple[int, ...] = ()
    max_new_tokens: Optional[int] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got "
                             f"{self.top_p}")
        stops = tuple(int(t) for t in self.stop_ids)
        if any(t < 0 for t in stops):
            raise ValueError(f"stop_ids must be token ids, got {stops}")
        if len(stops) > MAX_STOP_IDS:
            raise ValueError(
                f"at most {MAX_STOP_IDS} stop_ids per request "
                f"(got {len(stops)}; the blocked decode carries a fixed "
                f"number of per-slot stop slots)")
        object.__setattr__(self, "stop_ids", stops)
        if self.max_new_tokens is not None and self.max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got "
                             f"{self.max_new_tokens}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0
