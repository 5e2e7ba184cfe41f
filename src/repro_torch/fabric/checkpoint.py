"""Prepared-engine checkpointing: serve-ready state on disk (the port's
copy of ``repro/fabric/checkpoint.py``, on the same format).

``save_engine_checkpoint`` persists everything needed to come back as
the SAME replica: the engine's prepared param tree (packed int8/int4
storage, fp codes, scales, calibrated activation scales, bit for bit
via ``repro_torch.checkpoint``'s self-describing manifest) plus the
resolved ``ModelConfig`` and ``EngineConfig`` in the checkpoint
metadata, under the reference's keys: either package restores what the
other saved.

``build_engine`` is the restore path: it reconstructs a
``ServingEngine`` from the checkpoint alone, with no raw fp32 weights,
no re-quantization and no calibration pass. ``prepare_params`` passes
prepared containers through untouched, and the saved activation scales
feed back through ``EngineConfig(act_calibration=<dict>)``, whose dict
path runs no calibration forward.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch.checkpoint import (CheckpointNotFound, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import ModelConfig, MoESpec
from repro_torch.serving.config import EngineConfig

FABRIC_KEY = "fabric"
FORMAT_VERSION = 1


# ------------------------------------------------------- config round trip
#
# MessagePack has no tuples: everything tuple-typed (rec_pattern) comes
# back as a list, so the rebuild coerces per field against the
# dataclass schema instead of trusting the wire types.

def model_config_to_dict(cfg: ModelConfig) -> Dict:
    return dataclasses.asdict(cfg)


def model_config_from_dict(d: Dict) -> ModelConfig:
    d = dict(d)
    if d.get("moe") is not None:
        d["moe"] = MoESpec(**d["moe"])
    if d.get("rec_pattern") is not None:
        d["rec_pattern"] = tuple(d["rec_pattern"])
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"checkpoint model config carries unknown fields "
            f"{sorted(unknown)} (schema drift — re-save the checkpoint)")
    return ModelConfig(**d)


def engine_config_to_dict(config: EngineConfig) -> Dict:
    d = dataclasses.asdict(config)
    # the calibration INPUT is not serve-ready state: the resolved
    # scales are saved as act_scales, and 'auto' must not trigger a
    # calibration pass on restore
    d.pop("act_calibration", None)
    return d


def engine_config_from_dict(d: Dict,
                            act_scales: Optional[Dict]) -> EngineConfig:
    d = dict(d)
    d.pop("act_calibration", None)
    known = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"checkpoint engine config carries unknown fields "
            f"{sorted(unknown)} (schema drift — re-save the checkpoint)")
    return EngineConfig(act_calibration=act_scales, **d)


# ------------------------------------------------------------ save/restore

def save_engine_checkpoint(engine, directory: str, step: int = 0) -> str:
    """Persist a constructed ``ServingEngine`` as a serve-ready
    checkpoint: prepared params as the array payload, resolved configs
    and activation scales in the manifest metadata."""
    scales = None
    if engine.act_scales is not None:
        scales = {k: float(v) for k, v in engine.act_scales.items()}
    meta = {
        FABRIC_KEY: {
            "version": FORMAT_VERSION,
            "model_config": model_config_to_dict(engine.cfg),
            "engine_config": engine_config_to_dict(engine.config),
            "act_scales": scales,
            "policy": engine.cfg.precision_policy,
            "prepared": bool(engine.prepared),
        }
    }
    return save_checkpoint(directory, step, engine.params, metadata=meta)


def load_engine_checkpoint(directory: str, step: Optional[int] = None,
                           device=None,
                           ) -> Tuple[ModelConfig, EngineConfig, Any,
                                      Optional[Dict], Dict]:
    """Restore ``(model_cfg, engine_cfg, params, act_scales, meta)``
    from a serve-ready checkpoint, the params on ``device`` (CUDA
    unless ``device="cpu"``), every leaf's checksum verified."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise CheckpointNotFound(
                f"no checkpoints under {directory!r}")
    params, meta = restore_checkpoint(directory, step, device=device)
    fab = meta.get(FABRIC_KEY)
    if fab is None:
        raise ValueError(
            f"checkpoint at {directory!r} step {step} is not a fabric "
            f"engine checkpoint (no {FABRIC_KEY!r} metadata) — it "
            f"cannot rebuild a ServingEngine; restore it with "
            f"repro_torch.checkpoint.restore_checkpoint instead")
    cfg = model_config_from_dict(fab["model_config"])
    act_scales = fab.get("act_scales")
    config = engine_config_from_dict(fab["engine_config"], act_scales)
    return cfg, config, params, act_scales, fab


def build_engine(directory: str, step: Optional[int] = None, *,
                 api=None, scheduler=None, clock=None,
                 config_overrides: Optional[Dict] = None, device=None):
    """Reconstruct a serve-ready ``ServingEngine`` on ``device`` (CUDA
    unless ``device="cpu"``; without CUDA that default raises) from a
    checkpoint.

    The prepared tree passes straight through the engine's
    construction-time prepare and the saved activation scales ride in
    as the dict ``act_calibration``, so the rebuilt engine performs zero
    weight quantizations and zero calibration forwards, and serves the
    saved engine's token streams. ``config_overrides`` patches
    EngineConfig fields that are deployment-local rather than replica
    identity (e.g. ``trace``, ``cost_correction``)."""
    from repro_torch.device import resolve_device
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServingEngine

    device = resolve_device(device)
    cfg, config, params, _, _ = load_engine_checkpoint(directory, step,
                                                       device=device)
    if config_overrides:
        config = dataclasses.replace(config, **config_overrides)
    if api is None:
        api = registry.build(cfg)
    return ServingEngine(cfg, api, params, config=config,
                         scheduler=scheduler,
                         clock=clock if clock is not None
                         else time.monotonic, device=device)
