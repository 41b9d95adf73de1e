"""NaiveBayes — multinomial / complement / bernoulli / gaussian.

Counterpart of ``sntc_tpu/models/naive_bayes.py`` (Spark's
``NaiveBayes``, all four ``modelType``s):

  * ``multinomial``: θ_cj = log((Σ_c w·x_j + λ) / (Σ_c w·Σ_j x_j + λD));
    raw = x·θ_c + log π_c.  Features must be non-negative.
  * ``complement``: per-class statistics of all OTHER classes,
    normalized and negated; no class prior.
  * ``bernoulli``: features must be 0/1; raw = x·(log p − log(1−p)) +
    Σ log(1−p) + log π.
  * ``gaussian``: per-(class, feature) mean and variance with
    ε = 1e-9 · the largest global variance; raw = the Gaussian
    log-likelihood + log π.

Priors: the discrete types use Spark's λ-smoothed priors
``log((n_c + λ) / (n + Cλ))``; the gaussian type keeps unsmoothed
``log(n_c / n)`` priors.

The fit is one pass over the rows on the estimator's device (class
weights, Σw(x−p) and Σw(x−p)² about a pilot row ``p``, as one-hot
products in full float32) and, for the gaussian type, a second pass of
squared deviations about each row's own class mean.  The model is
finished in float64 on the host.  With a ``mesh=`` of more than one
shard the rows are laid out by ``shard_batch`` and each pass is one
``make_tree_aggregate``: every shard's moments on its device, summed in
shard order (the pilot and the class means given whole to each shard).
``partial_fit`` runs the first pass on each mini-batch and folds it
into a host float64 state (``lifecycle.incremental.NBPartialFitState``);
the gaussian variance then comes from the accumulated pilot-shifted
moments by the one-pass shift identity.  Serving a discrete type is one f32
product, a shifted softmax and the packed raw | prob | prediction block
on the model's device.  The gaussian log-likelihood runs in float64 on
the model's device (f32 sums flip the argmax on flow data), one class at
a time so that its working set stays ``[N, F]``; the model says it has
no fusible device program, so the fusion planner leaves it staged, as
the JAX package's does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.models.base import (
    ClassificationModel,
    ClassifierEstimator,
    DeviceHeadMixin,
    pack_serve_outputs,
)
from sntc_tpu_torch.ops.lbfgs import full_f32
from sntc_tpu_torch.parallel.collectives import (
    ShardedArray,
    fit_device,
    fit_mesh,
    fit_rows,
    make_tree_aggregate,
)


def _moments_block(xs, ys, ws, pilot, k: int) -> torch.Tensor:
    shifted = xs - pilot[None, :]
    oh = torch.nn.functional.one_hot(ys, k).to(xs.dtype) * ws[:, None]
    return torch.cat([oh.sum(0)[:, None], oh.t() @ shifted,
                      oh.t() @ (shifted * shifted)], dim=1)


def _sq_block(xs, ys, ws, mu, k: int) -> torch.Tensor:
    diff = xs - mu[ys]
    oh = torch.nn.functional.one_hot(ys, k).to(xs.dtype) * ws[:, None]
    return oh.t() @ (diff * diff)


def _on_rows(block_fn, xs, ys, ws, const: np.ndarray, k: int, op: str):
    """``block_fn(xs, ys, ws, const, k)`` over the rows on their device,
    or over sharded rows as one aggregate (``const`` given whole to every
    shard), as a float64 host array."""
    const_t = torch.from_numpy(np.asarray(const, np.float32))
    if isinstance(xs, ShardedArray):
        out = make_tree_aggregate(
            lambda x, y, w, c: block_fn(x, y, w, c, k), xs.mesh,
            replicated_args=(3,), op=op)(xs, ys, ws, const_t)
    else:
        out = block_fn(xs, ys, ws, const_t.to(xs.device), k)
    return out.cpu().numpy().astype(np.float64)


def _class_moments(xs, ys, ws, pilot, k: int):
    """One pass: per-class weight ``[C]``, Σw·(x−p) and Σw·(x−p)² ``[C,
    F]`` about the pilot row ``p`` (raw f32 Σx² cancels on features whose
    mean dwarfs their spread), as float64 host arrays."""
    out = _on_rows(_moments_block, xs, ys, ws, pilot, k, "nb.moments")
    d = xs.shape[1]
    return out[:, 0], out[:, 1:1 + d], out[:, 1 + d:]


def _class_sq_about_mean(xs, ys, ws, mu, k: int) -> np.ndarray:
    """Second gaussian pass: Σ_c w·(x − μ_c)² ``[C, F]`` with each row
    deviated about its OWN class mean.  One pass of E[x²]−E[x]², even
    pilot-shifted, cancels small class variances away when a feature's
    overall spread is huge (flow durations span ~1e8)."""
    return _on_rows(_sq_block, xs, ys, ws, mu, k, "nb.sq_about_mean")


def _pack_log_joint(raw, thr, *, mode):
    """A shifted softmax of the per-class log-joint ``raw`` for the
    probability, packed ``[N, 2C+1]`` with it."""
    e = torch.exp(raw - raw.max(dim=1, keepdim=True).values)
    return pack_serve_outputs(raw, e / e.sum(dim=1, keepdim=True), thr, mode)


def gaussian_raw(X, mu, var, log_pi) -> torch.Tensor:
    """``[N, C]`` float64 on ``X``'s device: −½ Σ_j (log 2πσ² +
    (x−μ)²/σ²) + log π, one class at a time (a ``[N, C, F]`` broadcast
    would take ~26 GB at CICIDS scale)."""
    X = X.to(torch.float64)
    C = mu.shape[0]
    ll = torch.empty((X.shape[0], C), dtype=torch.float64, device=X.device)
    log_2pi_var = torch.log((2.0 * math.pi) * var)
    for c in range(C):
        diff = X - mu[c]
        ll[:, c] = -0.5 * (log_2pi_var[c] + diff * diff / var[c]).sum(dim=1)
    return ll + log_pi[None, :]


class _NbParams:
    smoothing = Param(
        "additive (Laplace) smoothing λ", default=1.0,
        validator=validators.gteq(0.0),
    )
    modelType = Param(
        "multinomial | complement | bernoulli | gaussian",
        default="multinomial",
        validator=validators.one_of(
            "multinomial", "complement", "bernoulli", "gaussian"
        ),
    )


class NaiveBayes(_NbParams, ClassifierEstimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device), and returns a model whose
    parameters live on that device."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    @staticmethod
    def _validate_features(X: np.ndarray, mt: str) -> None:
        if mt in ("multinomial", "complement") and (X < 0).any():
            raise ValueError(f"{mt} NaiveBayes requires non-negative features")
        if mt == "bernoulli" and not np.isin(X, (0.0, 1.0)).all():
            raise ValueError("bernoulli NaiveBayes requires 0/1 features")

    def _with_params(self, model: "NaiveBayesModel") -> "NaiveBayesModel":
        model.setParams(
            **{k2: v for k2, v in self.paramValues().items()
               if model.hasParam(k2)}
        )
        return model

    def _discrete_model(self, cw, s, k, D) -> "NaiveBayesModel":
        """multinomial/complement/bernoulli model from the f64 class
        weights ``cw`` [C] and raw weighted feature sums ``s`` [C, F]."""
        mt = self.getModelType()
        lam = float(self.getSmoothing())
        n = cw.sum()
        log_pi = np.log(np.maximum(cw, 1e-300)) - np.log(max(n, 1e-300))
        # Spark's λ-smoothed prior log((n_c + λ)/(n + Cλ))
        log_pi_smoothed = np.log(cw + lam) - np.log(max(n + k * lam, 1e-300))
        if mt == "multinomial":
            num = s + lam
            den = s.sum(axis=1, keepdims=True) + lam * D
            theta = np.log(num) - np.log(den)  # [C, F]
            bias = log_pi_smoothed
        elif mt == "complement":
            comp = s.sum(axis=0, keepdims=True) - s
            num = comp + lam
            den = comp.sum(axis=1, keepdims=True) + lam * D
            logp = np.log(num) - np.log(den)
            theta = -logp / np.abs(logp).sum(axis=1, keepdims=True)
            bias = np.zeros_like(log_pi)  # complement NB drops the prior
        else:  # bernoulli
            p = (s + lam) / (cw[:, None] + 2.0 * lam)  # P(x_j=1 | c)
            logp, log1mp = np.log(p), np.log1p(-p)
            theta = logp - log1mp
            bias = log_pi_smoothed + log1mp.sum(axis=1)
        return self._with_params(NaiveBayesModel(
            theta=theta.astype(np.float32), bias=bias.astype(np.float32),
            pi=log_pi, n_classes=k, device=self.device,
        ))

    def _gaussian_model(self, cw, mu, sq_c, k) -> "NaiveBayesModel":
        """gaussian model from class weights, f64 class means and the
        squared deviations about them (``sq_c`` = Σ_c w·(x−μ_c)²)."""
        n = cw.sum()
        log_pi = np.log(np.maximum(cw, 1e-300)) - np.log(max(n, 1e-300))
        var = np.maximum(sq_c / np.maximum(cw[:, None], 1e-300), 0.0)
        # ε = 1e-9 · the largest GLOBAL feature variance (sklearn's
        # var_smoothing), rebuilt as within- plus between-class terms
        if var.size and n > 0:
            mu_bar = (cw[:, None] * mu).sum(axis=0) / n
            between = (cw[:, None] * (mu - mu_bar[None, :]) ** 2).sum(axis=0)
            global_var = (sq_c.sum(axis=0) + between) / n
            eps = 1e-9 * float(global_var.max())
        else:
            eps = 1e-12
        var = var + max(eps, 1e-12)
        return self._with_params(NaiveBayesModel(
            pi=log_pi, gaussian_mu=mu, gaussian_var=var, n_classes=k,
            device=self.device,
        ))

    def _fit(self, frame: Frame) -> "NaiveBayesModel":
        X, y, w = self._extract(frame)
        mt = self.getModelType()
        k = max(int(y.max()) + 1 if len(y) else 2, 2)
        D = X.shape[1]
        self._validate_features(X, mt)
        xs, ys, ws = fit_rows(X, y, w, self.device, fit_mesh(self.mesh))
        pilot = (np.asarray(X[0], np.float32) if len(X)
                 else np.zeros(D, np.float32))
        p64 = pilot.astype(np.float64)
        with full_f32():
            cw, s_sh, _ = _class_moments(xs, ys, ws, pilot, k)
            if mt == "gaussian":
                # two passes: the means, then deviations about each
                # row's own class mean
                mu = p64[None, :] + s_sh / np.maximum(cw[:, None], 1e-300)
                sq_c = _class_sq_about_mean(xs, ys, ws, mu, k)
                return self._gaussian_model(cw, mu, sq_c, k)
        # raw weighted sums, rebuilt exactly in f64
        s = s_sh + cw[:, None] * p64[None, :]
        return self._discrete_model(cw, s, k, D)

    def partial_fit(self, frame: Frame, state=None, decay: float = 1.0,
                    n_classes: int = None):
        """One incremental update: fold this mini-batch's per-(class,
        feature) moments, taken on the estimator's device, into ``state``
        and return ``(model, state)``.

        The statistics are additive, so ``partial_fit`` over K shards
        matches the batch fit on their concatenation up to float32
        summation order.  The gaussian variance comes from the
        accumulated pilot-shifted moments by the identity Σw(x−μ)² =
        Σw(x−p)² − n_c(μ−p)², where the batch fit runs a second pass
        about the class means.  ``decay`` < 1 down-weights the history.
        The class count and the width are fixed by the first call (pass
        ``n_classes`` there when the label universe is known); a later
        shard with an out-of-range class raises."""
        from sntc_tpu_torch.lifecycle.incremental import NBPartialFitState

        X, y, w = self._extract(frame)
        self._validate_features(X, self.getModelType())
        if state is None:
            k = max(int(y.max()) + 1 if len(y) else 2, 2)
            if n_classes is not None:
                if k > int(n_classes):
                    raise ValueError(
                        f"label {int(y.max())} outside the declared "
                        f"n_classes={int(n_classes)}")
                k = max(int(n_classes), 2)
            pilot = (np.asarray(X[0], np.float32) if len(X)
                     else np.zeros(X.shape[1], np.float32))
            state = NBPartialFitState(n_classes=k, n_features=X.shape[1],
                                      pilot=pilot)
        else:
            if X.shape[1] != state.n_features:
                raise ValueError(
                    f"partial_fit feature width {X.shape[1]} != state's "
                    f"{state.n_features}")
            if len(y) and int(y.max()) >= state.n_classes:
                raise ValueError(
                    f"label {int(y.max())} outside the class set fixed "
                    f"at the first partial_fit call ({state.n_classes} "
                    "classes)")
        xs, ys, ws = fit_rows(X, y, w, self.device, fit_mesh(self.mesh))
        with full_f32():
            cw, s_sh, sq_sh = _class_moments(xs, ys, ws, state.pilot,
                                             state.n_classes)
        state.update(cw, s_sh, sq_sh, n_rows=len(y), decay=decay)
        return self._model_from_state(state), state

    def _model_from_state(self, state) -> "NaiveBayesModel":
        cw, s_sh, sq_sh = state.cw, state.s_sh, state.sq_sh
        p64 = state.pilot.astype(np.float64)
        k = state.n_classes
        if self.getModelType() == "gaussian":
            mu_sh = s_sh / np.maximum(cw[:, None], 1e-300)
            mu = p64[None, :] + mu_sh
            # one-pass shift identity: Σw(x−μ_c)² = Σw(x−p)² − n_c(μ_c−p)²
            sq_c = np.maximum(sq_sh - cw[:, None] * mu_sh ** 2, 0.0)
            return self._gaussian_model(cw, mu, sq_c, k)
        s = s_sh + cw[:, None] * p64[None, :]
        return self._discrete_model(cw, s, k, state.n_features)


class NaiveBayesModel(_NbParams, DeviceHeadMixin, ClassificationModel):
    def __init__(self, theta=None, bias=None, pi=None, gaussian_mu=None,
                 gaussian_var=None, n_classes: int = 2, device="cuda",
                 **kwargs):
        super().__init__(**kwargs)
        self.theta = None if theta is None else np.asarray(theta, np.float32)
        self.bias = None if bias is None else np.asarray(bias, np.float32)
        self.pi = None if pi is None else np.asarray(pi, np.float64)
        self.gaussian_mu = (None if gaussian_mu is None
                            else np.asarray(gaussian_mu, np.float64))
        self.gaussian_var = (None if gaussian_var is None
                             else np.asarray(gaussian_var, np.float64))
        self._n_classes = int(n_classes)
        self.device = resolve_device(device)
        self._thr_cache = None
        self._dev_params = None

    @property
    def num_classes(self) -> int:
        return self._n_classes

    def _save_extra(self):
        arrays = {"pi": self.pi}
        if self.theta is not None:
            arrays["theta"] = self.theta
            arrays["bias"] = self.bias
        if self.gaussian_mu is not None:
            arrays["gaussian_mu"] = self.gaussian_mu
            arrays["gaussian_var"] = self.gaussian_var
        return {"n_classes": self._n_classes}, arrays

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(
            theta=arrays.get("theta"), bias=arrays.get("bias"),
            pi=arrays.get("pi"), gaussian_mu=arrays.get("gaussian_mu"),
            gaussian_var=arrays.get("gaussian_var"),
            n_classes=int(extra["n_classes"]), device=device,
        )
        m.setParams(**params)
        return m

    def has_device_serve(self) -> bool:
        # the gaussian log-likelihood is a float64 program of its own,
        # not a packed f32 head the fusion planner folds into a segment
        return self.getModelType() != "gaussian"

    def _params_on_device(self) -> tuple:
        """The serving parameters on the model's device, uploaded once
        (after a ``modelType`` is known)."""
        if self._dev_params is None:
            def up(a, dt):
                return torch.from_numpy(np.ascontiguousarray(a, dt)).to(
                    self.device)

            if self.getModelType() == "gaussian":
                self._dev_params = (up(self.gaussian_mu, np.float64),
                                    up(self.gaussian_var, np.float64),
                                    up(self.pi, np.float64))
            else:
                self._dev_params = (up(self.theta.T, np.float32),
                                    up(self.bias, np.float32))
        return self._dev_params

    def _predict_all_dev(self, X) -> torch.Tensor:
        """Packed ``[N, 2C+1]``: float32 for the discrete types, float64
        for the gaussian type (its features cast to float32 first, as
        every head's are)."""
        mode, thr = self._serve_args()
        Xd = self._features_on_device(X)
        if self.getModelType() == "gaussian":
            raw = gaussian_raw(Xd, *self._params_on_device())
        else:  # raw = X @ θᵀ + bias, one f32 product
            thetaT, bias = self._params_on_device()
            raw = Xd @ thetaT + bias[None, :]
        return _pack_log_joint(raw, thr, mode=mode)
