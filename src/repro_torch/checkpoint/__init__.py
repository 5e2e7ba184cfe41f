"""Checkpoints of the port, on the reference's on-disk format."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointError,
    CheckpointManager,
    CheckpointNotFound,
    ChecksumError,
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
