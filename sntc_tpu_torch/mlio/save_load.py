"""ML persistence in the JAX package's directory format.

Counterpart of ``sntc_tpu/mlio/save_load.py``: each stage is a directory
holding ``metadata.json`` (``format_version``, ``class``, ``uid``,
``params``, ``extra``, and ``stage_dirs`` for the sub-stages of a
pipeline or of a stage with ``_sub_stages``, such as OneVsRest's models)
and, when the stage has arrays, ``data.npz``.  :func:`load_model` reads a
directory the JAX package saved; :func:`save_model` writes one that
either package loads.  Only ``json`` and ``numpy`` touch the files.

A stage is recorded under its JAX package class name, mapped to the
port class in :data:`PORTED_CLASSES`.  A class not ported yet, or an
orbax array payload, raises a clear error.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from sntc_tpu_torch.core.base import PipelineModel, PipelineStage
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.feature.chisq_selector import ChiSqSelectorModel
from sntc_tpu_torch.feature.standard_scaler import StandardScalerModel
from sntc_tpu_torch.feature.string_indexer import (
    IndexToString,
    StringIndexerModel,
)
from sntc_tpu_torch.feature.vector_assembler import VectorAssembler
from sntc_tpu_torch.models.logistic_regression import LogisticRegressionModel
from sntc_tpu_torch.models.mlp import MultilayerPerceptronClassificationModel
from sntc_tpu_torch.models.one_vs_rest import OneVsRestModel
from sntc_tpu_torch.models.tree.decision_tree import (
    DecisionTreeClassificationModel,
)
from sntc_tpu_torch.models.tree.gbt import GBTClassificationModel
from sntc_tpu_torch.models.tree.random_forest import (
    RandomForestClassificationModel,
)

_FORMAT_VERSION = 1

#: JAX package class name -> port class
PORTED_CLASSES: Dict[str, type] = {
    "sntc_tpu.core.base.PipelineModel": PipelineModel,
    "sntc_tpu.feature.string_indexer.StringIndexerModel": StringIndexerModel,
    "sntc_tpu.feature.string_indexer.IndexToString": IndexToString,
    "sntc_tpu.feature.vector_assembler.VectorAssembler": VectorAssembler,
    "sntc_tpu.feature.chisq_selector.ChiSqSelectorModel": ChiSqSelectorModel,
    "sntc_tpu.feature.standard_scaler.StandardScalerModel": StandardScalerModel,
    "sntc_tpu.models.mlp.MultilayerPerceptronClassificationModel":
        MultilayerPerceptronClassificationModel,
    "sntc_tpu.models.logistic_regression.LogisticRegressionModel":
        LogisticRegressionModel,
    "sntc_tpu.models.tree.random_forest.RandomForestClassificationModel":
        RandomForestClassificationModel,
    "sntc_tpu.models.tree.decision_tree.DecisionTreeClassificationModel":
        DecisionTreeClassificationModel,
    "sntc_tpu.models.tree.gbt.GBTClassificationModel": GBTClassificationModel,
    "sntc_tpu.models.one_vs_rest.OneVsRestModel": OneVsRestModel,
}
_SAVED_NAME = {cls: name for name, cls in PORTED_CLASSES.items()}


class _NpEncoder(json.JSONEncoder):
    def default(self, o: Any) -> Any:
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return super().default(o)


def _load_stage(path: str, device) -> PipelineStage:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"{path}: unsupported model format {meta.get('format_version')}"
        )
    qualname = meta["class"]
    cls = PORTED_CLASSES.get(qualname)
    if cls is None:
        raise NotImplementedError(
            f"{path}: stage class {qualname!r} is not ported to "
            f"sntc_tpu_torch yet (ported: {sorted(PORTED_CLASSES)})"
        )
    if meta.get("payload") == "orbax" or os.path.isdir(
        os.path.join(path, "data.orbax")
    ):
        raise NotImplementedError(
            f"{path}: orbax array payloads are not readable here; re-save "
            "the model with the default npz payload"
        )
    params = meta.get("params", {})
    extra = meta.get("extra", {})
    arrays: Dict[str, np.ndarray] = {}
    npz = os.path.join(path, "data.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            arrays = {k: z[k] for k in z.files}
    if cls is PipelineModel or hasattr(cls, "_from_sub_stages"):
        stages = [
            _load_stage(os.path.join(path, d), device)
            for d in meta.get("stage_dirs", [])
        ]
        if cls is PipelineModel:
            obj = PipelineModel(stages=stages)
            obj.setParams(**params)
        else:
            obj = cls._from_sub_stages(stages, params, extra)
    elif hasattr(cls, "_load_from"):
        obj = cls._load_from(params, extra, arrays, device)
    else:
        obj = cls()
        obj.setParams(**params)
    obj.uid = meta.get("uid", obj.uid)
    return obj


def load_model(path: str, device="cuda") -> PipelineStage:
    """Load a stage tree saved by either package; device-backed stages
    (the heads) place their tensors on ``device``."""
    return _load_stage(os.path.normpath(path), resolve_device(device))


def save_model(stage: PipelineStage, path: str) -> str:
    """Write ``stage`` (recursing over a pipeline's stages) as a stage
    directory the JAX package's ``load_model`` reads too."""
    cls_name = _SAVED_NAME.get(type(stage))
    if cls_name is None:
        raise NotImplementedError(
            f"{type(stage).__name__} has no counterpart to save as"
        )
    os.makedirs(path, exist_ok=True)
    params = dict(stage.paramValues())
    meta: Dict[str, Any] = {
        "format_version": _FORMAT_VERSION,
        "class": cls_name,
        "uid": stage.uid,
    }
    sub_stages = None
    if isinstance(stage, PipelineModel):
        sub_stages = params.pop("stages", [])
    elif hasattr(stage, "_sub_stages"):
        sub_stages = stage._sub_stages()
    if sub_stages is not None:
        meta["stage_dirs"] = []
        for i, sub in enumerate(sub_stages):
            sub_dir = f"stage_{i:03d}"
            save_model(sub, os.path.join(path, sub_dir))
            meta["stage_dirs"].append(sub_dir)
    extra, arrays = (
        stage._save_extra() if hasattr(stage, "_save_extra") else ({}, {})
    )
    arrays = {k: v for k, v in arrays.items() if v is not None}
    meta["params"] = params
    meta["extra"] = extra
    if arrays:
        meta["payload"] = "npz"
        np.savez(os.path.join(path, "data.npz"), **arrays)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, cls=_NpEncoder, indent=1)
    return path
