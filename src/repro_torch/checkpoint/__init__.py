"""Checkpointing over the compressed tensor store (``manager``)."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    ARCHIVE_NAME,
    MANIFEST_VERSION,
    CheckpointIntegrityError,
    CheckpointManager,
)
