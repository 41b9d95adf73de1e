from sntc_tpu_torch.mlio.save_load import (
    PORTED_CLASSES,
    CheckpointCorruptError,
    load_model,
    prev_checkpoint_path,
    save_model,
    verify_checkpoint,
)

__all__ = [
    "CheckpointCorruptError",
    "PORTED_CLASSES",
    "load_model",
    "prev_checkpoint_path",
    "save_model",
    "verify_checkpoint",
]
