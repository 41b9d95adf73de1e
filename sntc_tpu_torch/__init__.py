"""sntc_tpu_torch — the PyTorch/CUDA port of sntc_tpu, for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference it is
tested against.  It imports ``torch`` and never ``jax`` or ``sntc_tpu``.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package on
a ported path is a CUDA kernel written by hand for ``sm_90a``, built from
``kernels/csrc/`` at first use.

The port trains and serves multilayer-perceptron, logistic-regression,
random-forest, decision-tree and one-vs-rest gradient-boosted-tree
pipelines:

  core/        Params, Frame (numpy or device-tensor columns), Estimator,
               Pipeline, PipelineModel
  data/        CICIDS2017 schema, CSV ingest + cleaning, synthetic traffic
  feature/     VectorAssembler, ChiSqSelector, StandardScaler,
               StringIndexer (+ models), IndexToString
  ops/         quantile binning, the chi-square contingency, the
               LBFGS/OWLQN/projected-LBFGS minimizer
  models/      ClassificationModel, MultilayerPerceptronClassifier,
               LogisticRegression, RandomForestClassifier,
               DecisionTreeClassifier, GBTClassifier, OneVsRest (+ their
               models), the level-wise grower, the LBFGS fits' training
               summaries
  evaluation/  MulticlassClassificationEvaluator,
               BinaryClassificationEvaluator
  kernels/     tree_hist, forest_traversal, pad_assemble (CUDA) + their
               plain versions
  mlio/        load/save in the JAX package's directory format; mid-fit
               LBFGS and boosting-round checkpoints
  serve/       BatchPredictor (shape buckets), file-source streaming with
               an exactly-once offset log
  app.py       ``python -m sntc_tpu_torch train`` and ``serve``

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
