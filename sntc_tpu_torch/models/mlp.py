"""MultilayerPerceptronClassifier — feed-forward network, fit and serve.

Counterpart of ``sntc_tpu/models/mlp.py`` (Spark's
``MultilayerPerceptronClassifier``): ``layers=[in, hidden..., out]``,
sigmoid hidden activations, softmax output with cross-entropy,
full-batch LBFGS (``solver="l-bfgs"``, ``maxIter=100``) or gradient
descent (``solver="gd"``), Glorot-uniform init from numpy
``default_rng(seed)`` (so both packages start from the same weights) or
an ``initialWeights`` vector.  The weights are one flat vector, as in
Spark.

The fit keeps the rows on the estimator's device; every
``value_and_grad`` is the forward chain of ``torch.matmul`` and its
autograd backward, in full float32 (:func:`~sntc_tpu_torch.ops.lbfgs.full_f32`).
``computeDtype="bfloat16"`` rounds each product's inputs to bfloat16 and
multiplies in float32 — the JAX package's bf16 inputs with
``preferred_element_type=f32``, exactly: a product of two bf16 values is
exact in f32.  ``checkpointInterval``/``checkpointDir`` save the LBFGS
state through :func:`~sntc_tpu_torch.mlio.optimizer_checkpoint.run_segmented`.

Serving is one program per micro-batch on the model's device: margins,
softmax and prediction packed into one ``[N, 2K+1]`` tensor.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.models.base import (
    CheckpointParams,
    ClassificationModel,
    ClassifierEstimator,
    DeviceHeadMixin,
    pack_serve_outputs,
)
from sntc_tpu_torch.ops.lbfgs import LbfgsResult, full_f32, minimize_lbfgs


def _layer_sizes(layers: Tuple[int, ...]) -> List[Tuple[int, int]]:
    return [(layers[i], layers[i + 1]) for i in range(len(layers) - 1)]


def _n_weights(layers: Tuple[int, ...]) -> int:
    return sum(d_in * d_out + d_out for d_in, d_out in _layer_sizes(layers))


def _unpack(theta: torch.Tensor, layers: Tuple[int, ...]):
    """Flat vector -> [(W, b), ...] (Spark keeps MLP weights as one vector)."""
    out, off = [], 0
    for d_in, d_out in _layer_sizes(layers):
        W = theta[off : off + d_in * d_out].reshape(d_in, d_out)
        off += d_in * d_out
        b = theta[off : off + d_out]
        off += d_out
        out.append((W, b))
    return out


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to bfloat16, held in float32."""
    return a.to(torch.bfloat16).to(torch.float32)


def _forward(theta, X, layers, compute_dtype=torch.float32):
    """Margins (pre-softmax) of the final layer."""
    h = X
    wbs = _unpack(theta, layers)
    for i, (W, b) in enumerate(wbs):
        if compute_dtype == torch.bfloat16:
            z = _bf16(h) @ _bf16(W) + b[None, :]
        else:
            z = h @ W + b[None, :]
        h = torch.sigmoid(z) if i < len(wbs) - 1 else z
    return h


def value_and_grad_fn(loss_fn):
    """``theta -> (loss, d loss / d theta)`` by autograd, detached."""

    def value_and_grad(theta):
        t = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(t)
            (g,) = torch.autograd.grad(loss, t)
        return loss.detach(), g

    return value_and_grad


def _mlp_optimize(
    xs, ys, ws, theta0, init_state, iter_limit,
    *, layers, max_iter, tol, solver, step_size, resume=False,
    compute_dtype=torch.float32,
):
    w_sum = torch.sum(ws)

    def loss_fn(theta):
        margins = _forward(theta, xs, layers, compute_dtype)
        logp = torch.log_softmax(margins, dim=1)
        picked = torch.gather(logp, 1, ys[:, None])[:, 0]
        return -torch.sum(ws * picked) / w_sum

    value_and_grad = value_and_grad_fn(loss_fn)
    if solver == "l-bfgs":
        return minimize_lbfgs(
            value_and_grad, theta0, max_iter=max_iter, tol=tol,
            init_state=init_state if resume else None,
            return_state=True, iter_limit=iter_limit,
        )

    # solver == "gd": full-batch gradient descent with constant step
    hist = torch.zeros(max_iter + 1, dtype=theta0.dtype, device=theta0.device)
    theta = theta0
    for i in range(max_iter):
        f, g = value_and_grad(theta)
        hist[i] = f
        theta = theta - step_size * g
    f_final, _ = value_and_grad(theta)
    hist[max_iter] = f_final
    return (
        LbfgsResult(
            x=theta, loss=f_final, n_iters=max_iter, history=hist,
            converged=True, n_evals=max_iter + 1, n_syncs=0,
        ),
        None,  # gd has no resumable state (mid-fit checkpointing is l-bfgs)
    )


class _MlpParams:
    layers = Param(
        "layer sizes [in, hidden..., out]",
        validator=validators.list_of(lambda v: isinstance(v, (int, np.integer)) and v > 0),
    )
    maxIter = Param("max iterations", default=100, validator=validators.gteq(0))
    tol = Param("relative convergence tolerance", default=1e-6, validator=validators.gt(0))
    seed = Param("weight init seed", default=0)
    solver = Param(
        "l-bfgs | gd", default="l-bfgs", validator=validators.one_of("l-bfgs", "gd")
    )
    stepSize = Param("gd step size", default=0.03, validator=validators.gt(0))
    blockSize = Param(
        "row block size (API parity; the products take every row at once)",
        default=128,
        validator=validators.gt(0),
    )
    computeDtype = Param(
        "matmul input dtype: float32 | bfloat16 (inputs rounded to bf16, "
        "products accumulated in f32)",
        default="float32",
        validator=validators.one_of("float32", "bfloat16"),
    )


def glorot_init(layers: Tuple[int, ...], seed: int) -> np.ndarray:
    """Glorot-uniform weights per layer and zero biases, from numpy
    ``default_rng(seed)``: the JAX package's draws."""
    rng = np.random.default_rng(seed)
    parts = []
    for d_in, d_out in _layer_sizes(layers):
        limit = np.sqrt(6.0 / (d_in + d_out))
        parts.append(
            rng.uniform(-limit, limit, size=d_in * d_out).astype(np.float32)
        )
        parts.append(np.zeros(d_out, np.float32))
    return np.concatenate(parts)


class MultilayerPerceptronClassifier(_MlpParams, CheckpointParams, ClassifierEstimator):
    """Fits on ``device`` (default ``cuda``) and returns a model whose
    weights live on the same device."""

    def __init__(self, device="cuda", initialWeights: Optional[np.ndarray] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        self._initial_weights = initialWeights

    def _fit(self, frame: Frame) -> "MultilayerPerceptronClassificationModel":
        X, y, w = self._extract(frame)
        layers = tuple(int(v) for v in self.getLayers())
        if X.shape[1] != layers[0]:
            raise ValueError(
                f"layers[0]={layers[0]} but features have {X.shape[1]} columns"
            )
        if y.max(initial=0) >= layers[-1]:
            raise ValueError(
                f"label index {int(y.max())} >= output layer size {layers[-1]}"
            )
        if self._initial_weights is not None:
            theta0 = np.asarray(self._initial_weights, np.float32)
            if theta0.shape != (_n_weights(layers),):
                raise ValueError(
                    f"initialWeights must have {_n_weights(layers)} entries"
                )
        else:
            theta0 = glorot_init(layers, self.getSeed())

        dev = self.device
        xs = torch.from_numpy(np.require(X, requirements=["C", "W"])).to(dev)
        ys = torch.from_numpy(y.astype(np.int64)).to(dev)
        ws = torch.from_numpy(w).to(dev)
        theta0_t = torch.from_numpy(theta0).to(dev)
        compute_dtype = getattr(torch, self.getComputeDtype())

        def opt_call(init_state, resume, iter_limit):
            return _mlp_optimize(
                xs, ys, ws, theta0_t, init_state, iter_limit,
                layers=layers,
                max_iter=self.getMaxIter(),
                tol=self.getTol(),
                solver=self.getSolver(),
                step_size=self.getStepSize(),
                resume=resume,
                compute_dtype=compute_dtype,
            )

        fingerprint = {
            "algo": "mlp", "layers": list(layers), "seed": self.getSeed(),
            "maxIter": self.getMaxIter(), "tol": self.getTol(),
            "solver": self.getSolver(), "n_rows": int(X.shape[0]),
            "computeDtype": self.getComputeDtype(),
        }
        interval = (
            self.getCheckpointInterval()
            if self.getSolver() == "l-bfgs"
            else -1  # gd state is just theta; not checkpointed
        )
        # imported here: mlio imports the models to load them
        from sntc_tpu_torch.mlio.optimizer_checkpoint import run_segmented

        with full_f32():
            res = run_segmented(
                opt_call, self.getMaxIter(), interval,
                self.getCheckpointDir(), fingerprint,
            )

        model = MultilayerPerceptronClassificationModel(
            weights=res.x.cpu().numpy(), layers=list(layers), device=dev
        )
        model.setParams(
            **{k: v for k, v in self.paramValues().items() if model.hasParam(k)}
        )
        from sntc_tpu_torch.models.summary import ClassificationTrainingSummary

        n_iters = int(res.n_iters)
        model.summary = ClassificationTrainingSummary(
            res.history.cpu().numpy()[: n_iters + 1], n_iters, model, frame,
            labelCol=self.getLabelCol(),
        )
        model.optimizer_stats = {"iterations": n_iters,
                                 "evaluations": res.n_evals,
                                 "host_syncs": res.n_syncs}
        return model


def _mlp_serve(theta, X, thr, *, layers, mode):
    """raw + probability + prediction packed into one ``[N, 2K+1]``
    tensor: one device→host copy per serving micro-batch."""
    raw = _forward(theta, X, layers)
    prob = torch.softmax(raw, dim=1)
    return pack_serve_outputs(raw, prob, thr, mode)


class MultilayerPerceptronClassificationModel(
    _MlpParams, DeviceHeadMixin, ClassificationModel
):
    def __init__(self, weights: np.ndarray, layers: List[int], device="cuda",
                 **kwargs):
        super().__init__(**kwargs)
        self.weights = np.array(weights, np.float32)
        # read-only (own copy): the device copy is made once, so an
        # in-place edit would serve stale weights — make it raise instead
        self.weights.flags.writeable = False
        self.set("layers", list(layers))
        self.summary = None
        self.optimizer_stats = None
        self.device = resolve_device(device)
        self._dev_weights = torch.from_numpy(self.weights.copy()).to(self.device)
        self._thr_cache = None

    def _save_extra(self):
        return {}, {"weights": self.weights}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(weights=arrays["weights"], layers=params.get("layers"),
                device=device)
        m.setParams(**params)
        return m

    @property
    def num_classes(self) -> int:
        return int(self.getLayers()[-1])

    def _predict_all_dev(self, X) -> torch.Tensor:
        mode, thr = self._serve_args()
        return _mlp_serve(
            self._dev_weights, self._features_on_device(X), thr,
            layers=tuple(int(v) for v in self.getLayers()), mode=mode,
        )
