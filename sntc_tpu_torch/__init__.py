"""sntc_tpu_torch — the PyTorch/CUDA port of sntc_tpu, for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference it is
tested against.  It imports ``torch`` and never ``jax`` or ``sntc_tpu``.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package on
a ported path is a CUDA kernel written by hand for ``sm_90a``, built from
``kernels/csrc/`` at first use.

The port trains and serves multilayer-perceptron, logistic-regression,
random-forest, decision-tree, one-vs-rest gradient-boosted-tree,
naive-Bayes and one-vs-rest linear-SVM pipelines, the tree
regressors, and the clustering, topic and recommendation estimators:

  core/        Params, Frame (numpy or device-tensor columns), Estimator,
               Pipeline, PipelineModel
  data/        CICIDS2017 schema, CSV ingest + cleaning, synthetic traffic
  feature/     VectorAssembler, ChiSqSelector, StandardScaler,
               MinMaxScaler, MaxAbsScaler, RobustScaler, PCA,
               UnivariateFeatureSelector, VarianceThresholdSelector,
               StringIndexer (+ models), IndexToString, Normalizer,
               Binarizer, DCT
  ops/         quantile binning, the chi-square contingency, the
               LBFGS/OWLQN/projected-LBFGS minimizer and its
               lane-batched form
  models/      ClassificationModel (the host-serve crossover),
               MultilayerPerceptronClassifier,
               LogisticRegression, LinearSVC, NaiveBayes,
               RandomForestClassifier, DecisionTreeClassifier,
               GBTClassifier, OneVsRest, the DT/RF/GBT regressors (+
               their models), the level-wise grower, training summaries;
               KMeans, BisectingKMeans, GaussianMixture, LDA, ALS,
               PowerIterationClustering
  evaluation/  MulticlassClassificationEvaluator (every metric name),
               BinaryClassificationEvaluator, RegressionEvaluator,
               ClusteringEvaluator
  stat/        Correlation, ChiSquareTest, ANOVATest, FValueTest,
               KolmogorovSmirnovTest, Summarizer
  tuning/      ParamGridBuilder, CrossValidator, TrainValidationSplit
               (+ models); LogisticRegression grids and folds fit as
               lanes of one LBFGS loop
  resilience/  RetryPolicy, with_retries, fault_point and the event
               ring: the part tuning calls
  kernels/     tree_hist, forest_traversal, pad_assemble (CUDA) + their
               plain versions
  mlio/        load/save in the JAX package's directory format; mid-fit
               LBFGS and boosting-round checkpoints
  serve/       BatchPredictor (shape buckets), file-source streaming with
               an exactly-once offset log
  lifecycle/   drift monitor, NB/LR partial_fit states, shadow promotion
               and the between-batches hot swap
  fuse/        the whole-pipeline fusion compiler
  obs/         metrics registry and its exposition, span tracer,
               profiler capture, the fused segments' roofline
  utils/       the transfer ledger, MetricsLogger
  app.py       ``python -m sntc_tpu_torch train``, ``evaluate`` and
               ``serve``

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.base import (
    Estimator,
    Model,
    Pipeline,
    PipelineModel,
    Transformer,
)
from sntc_tpu_torch.core.params import Param, Params

__all__ = [
    "Frame",
    "Estimator",
    "Transformer",
    "Model",
    "Pipeline",
    "PipelineModel",
    "Param",
    "Params",
    "__version__",
]
