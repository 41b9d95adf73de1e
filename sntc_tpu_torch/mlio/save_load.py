"""ML persistence in the JAX package's directory format.

Counterpart of ``sntc_tpu/mlio/save_load.py``: each stage is a directory
holding ``metadata.json`` (``format_version``, ``class``, ``uid``,
``params``, ``extra``, and ``stage_dirs`` for the sub-stages of a
pipeline or of a stage with ``_sub_stages``, such as OneVsRest's models
or a tuning result's best model, estimator and evaluator)
and, when the stage has arrays, ``data.npz``.  :func:`load_model` reads a
directory the JAX package saved; :func:`save_model` writes one that
either package loads.  Only ``json`` and ``numpy`` touch the files.

A stage is recorded under its JAX package class name, mapped to the
port class in :data:`PORTED_CLASSES`: fitted stages, and the
estimators, evaluators and tuning specs a ``CrossValidator`` or
``TrainValidationSplit`` holds.  An estimator that fits on a device is
loaded onto ``load_model``'s.  A class not ported yet, or an orbax
array payload, raises a clear error.

Durability, as in the JAX package: :func:`save_model` writes the whole
stage tree into a staging directory (``<path>.tmp-<pid>``), seals it
with a sha256 manifest (``_manifest.json``) and publishes it by rename,
keeping the checkpoint it replaces at ``<path>.prev``; the live path is
never a partly written tree.  :func:`load_model` verifies the manifest
(``SNTC_VERIFY_CHECKPOINT=0`` skips the hashing) and, when the primary
is torn or corrupt, loads a verified ``<path>.prev`` instead with a
``ckpt_fallback`` event.  The fault sites are ``ckpt.save`` (after the
tree is staged, before the publish) and ``ckpt.load``.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import shutil
import sys
from typing import Any, Dict

import numpy as np

from sntc_tpu_torch.core.base import Pipeline, PipelineModel, PipelineStage
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.evaluation import (
    BinaryClassificationEvaluator,
    ClusteringEvaluator,
    MulticlassClassificationEvaluator,
    MultilabelClassificationEvaluator,
    RankingEvaluator,
    RegressionEvaluator,
)
from sntc_tpu_torch.feature.chisq_selector import ChiSqSelectorModel
from sntc_tpu_torch.feature.dct import DCT
from sntc_tpu_torch.feature.discretizers import (
    Bucketizer,
    Imputer,
    ImputerModel,
    QuantileDiscretizer,
)
from sntc_tpu_torch.feature.encoders import (
    ElementwiseProduct,
    OneHotEncoder,
    OneHotEncoderModel,
    VectorSlicer,
)
from sntc_tpu_torch.feature.expansion import Interaction, PolynomialExpansion
from sntc_tpu_torch.feature.hashing import FeatureHasher
from sntc_tpu_torch.feature.lsh import (
    BucketedRandomProjectionLSH,
    BucketedRandomProjectionLSHModel,
    MinHashLSH,
    MinHashLSHModel,
)
from sntc_tpu_torch.feature.pca import PCAModel
from sntc_tpu_torch.feature.rformula import RFormula, RFormulaModel
from sntc_tpu_torch.feature.scalers import (
    Binarizer,
    MaxAbsScalerModel,
    MinMaxScalerModel,
    Normalizer,
    RobustScalerModel,
)
from sntc_tpu_torch.feature.sql_transformer import SQLTransformer
from sntc_tpu_torch.feature.standard_scaler import (
    StandardScaler,
    StandardScalerModel,
)
from sntc_tpu_torch.feature.string_indexer import (
    IndexToString,
    StringIndexer,
    StringIndexerModel,
)
from sntc_tpu_torch.feature.text import (
    IDF,
    CountVectorizer,
    CountVectorizerModel,
    HashingTF,
    IDFModel,
    NGram,
    RegexTokenizer,
    StopWordsRemover,
    Tokenizer,
)
from sntc_tpu_torch.feature.univariate_selector import (
    UnivariateFeatureSelectorModel,
)
from sntc_tpu_torch.feature.variance_selector import (
    VarianceThresholdSelectorModel,
)
from sntc_tpu_torch.feature.vector_assembler import VectorAssembler
from sntc_tpu_torch.feature.vector_indexer import (
    VectorIndexer,
    VectorIndexerModel,
    VectorSizeHint,
)
from sntc_tpu_torch.feature.word2vec import Word2Vec, Word2VecModel
from sntc_tpu_torch.models.aft import (
    AFTSurvivalRegression,
    AFTSurvivalRegressionModel,
)
from sntc_tpu_torch.models.als import ALSModel
from sntc_tpu_torch.models.bisecting_kmeans import BisectingKMeansModel
from sntc_tpu_torch.models.fm import (
    FMClassificationModel,
    FMClassifier,
    FMRegressionModel,
    FMRegressor,
)
from sntc_tpu_torch.models.fpm import FPGrowth, FPGrowthModel
from sntc_tpu_torch.models.gaussian_mixture import GaussianMixtureModel
from sntc_tpu_torch.models.glm import (
    GeneralizedLinearRegression,
    GeneralizedLinearRegressionModel,
)
from sntc_tpu_torch.models.isotonic import (
    IsotonicRegression,
    IsotonicRegressionModel,
)
from sntc_tpu_torch.models.kmeans import KMeansModel
from sntc_tpu_torch.models.lda import LDAModel
from sntc_tpu_torch.models.linear_regression import (
    LinearRegression,
    LinearRegressionModel,
)
from sntc_tpu_torch.models.linear_svc import LinearSVCModel
from sntc_tpu_torch.models.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
)
from sntc_tpu_torch.models.mlp import MultilayerPerceptronClassificationModel
from sntc_tpu_torch.models.naive_bayes import NaiveBayesModel
from sntc_tpu_torch.models.one_vs_rest import OneVsRest, OneVsRestModel
from sntc_tpu_torch.models.tree.decision_tree import (
    DecisionTreeClassificationModel,
    DecisionTreeRegressionModel,
)
from sntc_tpu_torch.models.tree.gbt import GBTClassificationModel
from sntc_tpu_torch.models.tree.gbt_regressor import GBTRegressionModel
from sntc_tpu_torch.models.tree.random_forest import (
    RandomForestClassificationModel,
)
from sntc_tpu_torch.models.tree.random_forest_regressor import (
    RandomForestRegressionModel,
)
from sntc_tpu_torch.resilience.faults import fault_point
from sntc_tpu_torch.resilience.policy import emit_event
from sntc_tpu_torch.tuning import (
    CrossValidator,
    CrossValidatorModel,
    TrainValidationSplit,
    TrainValidationSplitModel,
)

_FORMAT_VERSION = 1
_MANIFEST = "_manifest.json"


class CheckpointCorruptError(RuntimeError):
    """The checkpoint tree fails manifest verification (torn write,
    bit-rot, partial copy); names the first offending file."""

#: JAX package class name -> port class
PORTED_CLASSES: Dict[str, type] = {
    "sntc_tpu.core.base.PipelineModel": PipelineModel,
    "sntc_tpu.feature.string_indexer.StringIndexerModel": StringIndexerModel,
    "sntc_tpu.feature.string_indexer.IndexToString": IndexToString,
    "sntc_tpu.feature.vector_assembler.VectorAssembler": VectorAssembler,
    "sntc_tpu.feature.chisq_selector.ChiSqSelectorModel": ChiSqSelectorModel,
    "sntc_tpu.feature.standard_scaler.StandardScalerModel": StandardScalerModel,
    "sntc_tpu.feature.scalers.MinMaxScalerModel": MinMaxScalerModel,
    "sntc_tpu.feature.scalers.MaxAbsScalerModel": MaxAbsScalerModel,
    "sntc_tpu.feature.scalers.RobustScalerModel": RobustScalerModel,
    "sntc_tpu.feature.scalers.Normalizer": Normalizer,
    "sntc_tpu.feature.scalers.Binarizer": Binarizer,
    "sntc_tpu.feature.dct.DCT": DCT,
    "sntc_tpu.feature.pca.PCAModel": PCAModel,
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
    "sntc_tpu.models.naive_bayes.NaiveBayesModel": NaiveBayesModel,
    "sntc_tpu.models.linear_svc.LinearSVCModel": LinearSVCModel,
    "sntc_tpu.models.tree.decision_tree.DecisionTreeRegressionModel":
        DecisionTreeRegressionModel,
    "sntc_tpu.models.tree.random_forest_regressor."
    "RandomForestRegressionModel": RandomForestRegressionModel,
    "sntc_tpu.models.tree.gbt_regressor.GBTRegressionModel":
        GBTRegressionModel,
    "sntc_tpu.models.kmeans.KMeansModel": KMeansModel,
    "sntc_tpu.models.bisecting_kmeans.BisectingKMeansModel":
        BisectingKMeansModel,
    "sntc_tpu.models.gaussian_mixture.GaussianMixtureModel":
        GaussianMixtureModel,
    "sntc_tpu.models.lda.LDAModel": LDAModel,
    "sntc_tpu.models.als.ALSModel": ALSModel,
    "sntc_tpu.feature.univariate_selector.UnivariateFeatureSelectorModel":
        UnivariateFeatureSelectorModel,
    "sntc_tpu.feature.variance_selector.VarianceThresholdSelectorModel":
        VarianceThresholdSelectorModel,
    "sntc_tpu.feature.encoders.OneHotEncoderModel": OneHotEncoderModel,
    "sntc_tpu.feature.encoders.VectorSlicer": VectorSlicer,
    "sntc_tpu.feature.encoders.ElementwiseProduct": ElementwiseProduct,
    "sntc_tpu.feature.expansion.PolynomialExpansion": PolynomialExpansion,
    "sntc_tpu.feature.expansion.Interaction": Interaction,
    "sntc_tpu.feature.discretizers.Bucketizer": Bucketizer,
    "sntc_tpu.feature.discretizers.ImputerModel": ImputerModel,
    "sntc_tpu.feature.vector_indexer.VectorIndexerModel": VectorIndexerModel,
    "sntc_tpu.feature.vector_indexer.VectorSizeHint": VectorSizeHint,
    "sntc_tpu.models.linear_regression.LinearRegressionModel":
        LinearRegressionModel,
    "sntc_tpu.models.aft.AFTSurvivalRegressionModel":
        AFTSurvivalRegressionModel,
    "sntc_tpu.models.isotonic.IsotonicRegressionModel":
        IsotonicRegressionModel,
    "sntc_tpu.models.glm.GeneralizedLinearRegressionModel":
        GeneralizedLinearRegressionModel,
    "sntc_tpu.models.fm.FMRegressionModel": FMRegressionModel,
    "sntc_tpu.models.fm.FMClassificationModel": FMClassificationModel,
    "sntc_tpu.feature.text.Tokenizer": Tokenizer,
    "sntc_tpu.feature.text.RegexTokenizer": RegexTokenizer,
    "sntc_tpu.feature.text.StopWordsRemover": StopWordsRemover,
    "sntc_tpu.feature.text.NGram": NGram,
    "sntc_tpu.feature.text.HashingTF": HashingTF,
    "sntc_tpu.feature.text.CountVectorizerModel": CountVectorizerModel,
    "sntc_tpu.feature.text.IDFModel": IDFModel,
    "sntc_tpu.feature.hashing.FeatureHasher": FeatureHasher,
    "sntc_tpu.feature.word2vec.Word2VecModel": Word2VecModel,
    "sntc_tpu.models.fpm.FPGrowthModel": FPGrowthModel,
    "sntc_tpu.feature.rformula.RFormulaModel": RFormulaModel,
    "sntc_tpu.feature.sql_transformer.SQLTransformer": SQLTransformer,
    "sntc_tpu.feature.lsh.BucketedRandomProjectionLSHModel":
        BucketedRandomProjectionLSHModel,
    "sntc_tpu.feature.lsh.MinHashLSHModel": MinHashLSHModel,
    # the estimators and evaluators a tuning spec holds
    "sntc_tpu.core.base.Pipeline": Pipeline,
    "sntc_tpu.feature.string_indexer.StringIndexer": StringIndexer,
    "sntc_tpu.feature.standard_scaler.StandardScaler": StandardScaler,
    "sntc_tpu.models.logistic_regression.LogisticRegression":
        LogisticRegression,
    "sntc_tpu.models.one_vs_rest.OneVsRest": OneVsRest,
    "sntc_tpu.feature.encoders.OneHotEncoder": OneHotEncoder,
    "sntc_tpu.feature.discretizers.QuantileDiscretizer": QuantileDiscretizer,
    "sntc_tpu.feature.discretizers.Imputer": Imputer,
    "sntc_tpu.feature.vector_indexer.VectorIndexer": VectorIndexer,
    "sntc_tpu.models.linear_regression.LinearRegression": LinearRegression,
    "sntc_tpu.models.aft.AFTSurvivalRegression": AFTSurvivalRegression,
    "sntc_tpu.models.isotonic.IsotonicRegression": IsotonicRegression,
    "sntc_tpu.models.glm.GeneralizedLinearRegression":
        GeneralizedLinearRegression,
    "sntc_tpu.models.fm.FMRegressor": FMRegressor,
    "sntc_tpu.models.fm.FMClassifier": FMClassifier,
    "sntc_tpu.feature.text.CountVectorizer": CountVectorizer,
    "sntc_tpu.feature.text.IDF": IDF,
    "sntc_tpu.feature.word2vec.Word2Vec": Word2Vec,
    "sntc_tpu.models.fpm.FPGrowth": FPGrowth,
    "sntc_tpu.feature.rformula.RFormula": RFormula,
    "sntc_tpu.feature.lsh.BucketedRandomProjectionLSH":
        BucketedRandomProjectionLSH,
    "sntc_tpu.feature.lsh.MinHashLSH": MinHashLSH,
    "sntc_tpu.evaluation.binary.BinaryClassificationEvaluator":
        BinaryClassificationEvaluator,
    "sntc_tpu.evaluation.multiclass.MulticlassClassificationEvaluator":
        MulticlassClassificationEvaluator,
    "sntc_tpu.evaluation.regression.RegressionEvaluator":
        RegressionEvaluator,
    "sntc_tpu.evaluation.clustering.ClusteringEvaluator":
        ClusteringEvaluator,
    "sntc_tpu.evaluation.ranking.RankingEvaluator": RankingEvaluator,
    "sntc_tpu.evaluation.ranking.MultilabelClassificationEvaluator":
        MultilabelClassificationEvaluator,
    "sntc_tpu.tuning.cross_validator.CrossValidator": CrossValidator,
    "sntc_tpu.tuning.cross_validator.CrossValidatorModel":
        CrossValidatorModel,
    "sntc_tpu.tuning.cross_validator.TrainValidationSplit":
        TrainValidationSplit,
    "sntc_tpu.tuning.cross_validator.TrainValidationSplitModel":
        TrainValidationSplitModel,
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
    if cls in (Pipeline, PipelineModel) or hasattr(cls, "_from_sub_stages"):
        stages = [
            _load_stage(os.path.join(path, d), device)
            for d in meta.get("stage_dirs", [])
        ]
        if cls in (Pipeline, PipelineModel):
            obj = cls(stages=stages)
            obj.setParams(**params)
        else:
            obj = cls._from_sub_stages(stages, params, extra)
    elif hasattr(cls, "_load_from"):
        obj = cls._load_from(params, extra, arrays, device)
    else:
        # an estimator that fits on a device fits on the loader's
        takes_device = "device" in inspect.signature(cls).parameters
        obj = cls(device=device) if takes_device else cls()
        obj.setParams(**params)
    obj.uid = meta.get("uid", obj.uid)
    return obj


# ---------------------------------------------------------------------------
# manifest: sha256 over every file of the staged tree
# ---------------------------------------------------------------------------


def _tree_files(root: str):
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            if rel != _MANIFEST:
                yield rel, full


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_manifest(root: str) -> None:
    files = {
        rel: {"sha256": _sha256(full), "bytes": os.path.getsize(full)}
        for rel, full in _tree_files(root)
    }
    tmp = os.path.join(root, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"manifest_version": 1, "files": files}, f, indent=1)
    os.replace(tmp, os.path.join(root, _MANIFEST))  # storage: checkpoint


def verify_checkpoint(path: str) -> bool:
    """Verify ``path`` against its manifest: True when verified, False
    when it has none (a checkpoint saved before manifests loads
    unchecked).  Raises :class:`CheckpointCorruptError` at the first
    mismatch; files beside the tree that the manifest does not name are
    tolerated."""
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            files = json.load(f)["files"]
    except (ValueError, KeyError, OSError) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint manifest {mpath}: {e!r}") from e
    hashing = os.environ.get("SNTC_VERIFY_CHECKPOINT", "1") != "0"
    for rel, want in files.items():
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            raise CheckpointCorruptError(
                f"checkpoint {path}: manifest file {rel!r} is missing")
        size = os.path.getsize(full)
        if size != want["bytes"]:
            raise CheckpointCorruptError(
                f"checkpoint {path}: {rel!r} is {size} bytes, manifest "
                f"says {want['bytes']} (torn write)")
        if hashing:
            got = _sha256(full)
            if got != want["sha256"]:
                raise CheckpointCorruptError(
                    f"checkpoint {path}: {rel!r} sha256 mismatch "
                    f"(expected {want['sha256'][:12]}…, got {got[:12]}…)")
    return True


def prev_checkpoint_path(path: str) -> str:
    """Where :func:`save_model` keeps the snapshot it replaced."""
    return os.path.normpath(path) + ".prev"


def load_model(path: str, device="cuda",
               fallback: bool = True) -> PipelineStage:
    """Load a stage tree saved by either package, verifying its manifest
    when it has one; device-backed stages (the heads) place their
    tensors on ``device``.  A primary that fails to verify or load falls
    back to a verified ``<path>.prev`` (a ``ckpt_fallback`` event and a
    warning on stderr); with neither, or ``fallback=False``, the
    primary's error propagates."""
    path = os.path.normpath(path)
    device = resolve_device(device)
    try:
        # inside the try: an injected ckpt.load fault degrades as a
        # real load failure does
        fault_point("ckpt.load")
        verify_checkpoint(path)
        return _load_stage(path, device)
    except Exception as primary_err:
        prev = prev_checkpoint_path(path)
        if not fallback or not os.path.isdir(prev):
            raise
        try:
            verify_checkpoint(prev)
            obj = _load_stage(prev, device)
        except Exception:
            raise primary_err  # both bad: report the primary's failure
        emit_event(event="ckpt_fallback", site="ckpt.load", path=path,
                   fallback_path=prev, error=repr(primary_err))
        print(f"sntc_tpu_torch: checkpoint {path!r} failed to load "
              f"({primary_err!r}); degraded to previous good snapshot "
              f"{prev!r}", file=sys.stderr)
        return obj


def _save_stage(stage: PipelineStage, path: str) -> None:
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
    if isinstance(stage, (Pipeline, PipelineModel)):
        sub_stages = params.pop("stages", [])
    elif hasattr(stage, "_sub_stages"):
        sub_stages = stage._sub_stages()
    if sub_stages is not None:
        meta["stage_dirs"] = []
        for i, sub in enumerate(sub_stages):
            sub_dir = f"stage_{i:03d}"
            _save_stage(sub, os.path.join(path, sub_dir))
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


def save_model(stage: PipelineStage, path: str) -> str:
    """Persist ``stage`` at ``path`` by atomic publish (see the module
    docs): staged at ``<path>.tmp-<pid>``, sealed with a manifest,
    renamed in; the checkpoint it replaces is kept at ``<path>.prev``.
    A failure before the rename (an armed ``ckpt.save`` included)
    leaves the previous checkpoint intact."""
    path = os.path.normpath(path)
    staging = f"{path}.tmp-{os.getpid()}"
    if os.path.isdir(staging):
        shutil.rmtree(staging)
    prev = prev_checkpoint_path(path)
    moved_aside = False
    try:
        _save_stage(stage, staging)
        fault_point("ckpt.save")
        _write_manifest(staging)
        if os.path.isdir(path):
            if os.path.isdir(prev):
                shutil.rmtree(prev)
            os.replace(path, prev)  # storage: checkpoint
            moved_aside = True
        os.replace(staging, path)  # storage: checkpoint
    except BaseException:
        # the old tree already moved aside and the publish failed: put
        # it back, never leave the path empty with the good tree at .prev
        if moved_aside and not os.path.isdir(path) and os.path.isdir(prev):
            os.replace(prev, path)  # storage: checkpoint
        if os.path.isdir(staging):
            shutil.rmtree(staging, ignore_errors=True)
        raise
    return path
