from sntc_tpu_torch.mlio.save_load import PORTED_CLASSES, load_model, save_model

__all__ = ["PORTED_CLASSES", "load_model", "save_model"]
