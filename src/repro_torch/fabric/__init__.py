"""Serve-ready engine checkpoints (the ``checkpoint`` part of the
reference's ``repro/fabric``; its transport, worker and controller are
not ported yet)."""
from repro_torch.fabric.checkpoint import (  # noqa: F401
    build_engine, load_engine_checkpoint, save_engine_checkpoint)
