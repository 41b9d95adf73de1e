from sntc_tpu_torch.core.params import Param, Params, validators
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.base import (
    Estimator,
    Evaluator,
    Model,
    Pipeline,
    PipelineModel,
    PipelineStage,
    Transformer,
)

__all__ = [
    "Param",
    "Params",
    "validators",
    "Frame",
    "to_host",
    "PipelineStage",
    "Transformer",
    "Estimator",
    "Evaluator",
    "Model",
    "Pipeline",
    "PipelineModel",
]
