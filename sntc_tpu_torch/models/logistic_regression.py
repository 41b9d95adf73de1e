"""LogisticRegression — binomial/multinomial elastic-net logit, fit and serve.

Counterpart of ``sntc_tpu/models/logistic_regression.py`` (Spark's
``LogisticRegression``), its single-fit path:

  * ``family`` auto/binomial/multinomial; elastic net via ``regParam`` ×
    ``elasticNetParam`` (L1 -> OWLQN, else LBFGS), intercepts
    unpenalized; bound constraints on coefficients and intercepts
    (projected LBFGS);
  * internal feature standardization during optimization (coefficients
    returned in the original space); ``standardization=False`` keeps the
    scaled optimization but re-weights the penalty as Spark does;
  * intercepts initialized to the label-prior log odds;
  * ``objectiveHistory`` on the training summary.

The fit is one summarizer pass (moments and class counts) and then the
LBFGS/OWLQN loop of :mod:`sntc_tpu_torch.ops.lbfgs`, with the rows on
the estimator's device and every product in full float32.  The class
counts are a one-hot product, not a scatter of atomics, so the fit is
the same run to run.  The summarizer takes raw Σx² (not pilot-shifted,
unlike the scaler), as the JAX package does.

Not ported: the batched grid and fold lanes (``_fit_grid``,
``_fit_grid_folds``), the one-vs-rest lanes (``_fit_ovr_lanes``) and
``partial_fit``; ``supports_batched_grid`` and
``supports_vectorized_ovr`` say False.
"""

from __future__ import annotations

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
from sntc_tpu_torch.models.mlp import value_and_grad_fn
from sntc_tpu_torch.models.summary import (
    BinaryClassificationTrainingSummary,
    ClassificationTrainingSummary,
)
from sntc_tpu_torch.ops.lbfgs import full_f32, minimize_lbfgs


def _lr_summarize(xs, ys, ws, k):
    """Σw·x, Σw·x², Σw and the per-class Σw in one pass, as float64
    host arrays; the class sums are ``ws @ one_hot(ys)``."""
    onehot = torch.nn.functional.one_hot(ys, k).to(ws.dtype)
    d = xs.shape[1]
    out = torch.cat([ws @ xs, ws @ (xs * xs), ws.sum().reshape(1),
                     ws @ onehot]).cpu().numpy().astype(np.float64)
    return out[:d], out[d:2 * d], out[2 * d], out[2 * d + 1:]


def _lr_loss(
    theta, xs, ys, ws, inv_std, l2, pen_l2, w_sum,
    *, binomial, fit_intercept, k, n_coef,
):
    """Smooth objective: the weighted mean log loss plus the L2 term."""
    d = xs.shape[1]
    coef = theta[:n_coef]
    W = coef.reshape(d, 1) if binomial else coef.reshape(d, k)
    b = (
        theta[n_coef:]
        if fit_intercept
        else torch.zeros(1 if binomial else k, dtype=theta.dtype,
                         device=theta.device)
    )
    Wd = W * inv_std[:, None]  # fold scaling into the matmul
    margins = xs @ Wd + b[None, :]
    if binomial:
        z = margins[:, 0]
        yf = ys.to(z.dtype)
        data = torch.sum(ws * (torch.logaddexp(torch.zeros_like(z), z) - yf * z))
    else:
        logp = torch.log_softmax(margins, dim=1)
        picked = torch.gather(logp, 1, ys[:, None])[:, 0]
        data = -torch.sum(ws * picked)
    data = data / w_sum
    penalty = 0.5 * l2 * torch.sum(pen_l2 * theta[:n_coef] ** 2)
    return data + penalty


def _lr_optimize(
    xs, ys, ws, inv_std, l2, pen_l2, l1_vec, theta0, init_state, iter_limit,
    lb, ub,
    *, binomial, fit_intercept, k, max_iter, tol, use_l1, resume=False,
    use_bounds=False,
):
    """The whole LBFGS/OWLQN fit over the rows on their device."""
    d = xs.shape[1]
    n_coef = d if binomial else d * k
    w_sum = torch.sum(ws)

    def loss_fn(theta):
        return _lr_loss(
            theta, xs, ys, ws, inv_std, l2, pen_l2, w_sum,
            binomial=binomial, fit_intercept=fit_intercept, k=k,
            n_coef=n_coef,
        )

    return minimize_lbfgs(
        value_and_grad_fn(loss_fn),
        theta0,
        max_iter=max_iter,
        tol=tol,
        l1=l1_vec if use_l1 else None,
        init_state=init_state if resume else None,
        return_state=True,
        iter_limit=iter_limit,
        bounds=(lb, ub) if use_bounds else None,
    )


class _LrParams:
    maxIter = Param("max LBFGS/OWLQN iterations", default=100, validator=validators.gteq(0))
    regParam = Param("regularization strength", default=0.0, validator=validators.gteq(0))
    elasticNetParam = Param(
        "elastic-net mixing: 0=L2, 1=L1", default=0.0, validator=validators.in_range(0, 1)
    )
    tol = Param("relative convergence tolerance", default=1e-6, validator=validators.gt(0))
    fitIntercept = Param("fit intercept term", default=True, validator=validators.is_bool())
    standardization = Param(
        "standardize features during optimization", default=True,
        validator=validators.is_bool(),
    )
    family = Param(
        "binomial | multinomial | auto", default="auto",
        validator=validators.one_of("auto", "binomial", "multinomial"),
    )
    lowerBoundsOnCoefficients = Param(
        "coefficient lower bounds, shape [1, D] (binomial) or [K, D]; "
        "requires elasticNetParam contributions of L1 to be zero",
        default=None,
    )
    upperBoundsOnCoefficients = Param(
        "coefficient upper bounds, same shape as the lower bounds",
        default=None,
    )
    lowerBoundsOnIntercepts = Param(
        "intercept lower bounds, length 1 (binomial) or K", default=None
    )
    upperBoundsOnIntercepts = Param(
        "intercept upper bounds, length 1 (binomial) or K", default=None
    )


def _bounds_digest(lb: np.ndarray, ub: np.ndarray) -> str:
    import hashlib

    h = hashlib.md5()
    h.update(np.ascontiguousarray(lb, np.float32).tobytes())
    h.update(np.ascontiguousarray(ub, np.float32).tobytes())
    return h.hexdigest()


class LogisticRegression(_LrParams, CheckpointParams, ClassifierEstimator):
    """Fits on ``device`` (default ``cuda``) and returns a model whose
    coefficients live on the same device."""

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def supports_batched_grid(self, param_maps) -> bool:
        """The batched grid program is not ported: grids fit one by one."""
        return False

    def supports_vectorized_ovr(self) -> bool:
        """The one-vs-rest lanes are not ported: classes fit one by one."""
        return False

    def _build_bounds(self, d, k, binomial, n_coef, n_int, std):
        """Flatten user bounds into theta-ordered (lb, ub) vectors.

        Bounds are declared on ORIGINAL-space coefficients; the optimizer
        works in the scaled space ``coef_scaled = coef_orig * std``, so
        coefficient bounds scale by ``std`` per feature.  Intercepts are
        never scaled.
        """
        lbc = self.getLowerBoundsOnCoefficients()
        ubc = self.getUpperBoundsOnCoefficients()
        lbi = self.getLowerBoundsOnIntercepts()
        ubi = self.getUpperBoundsOnIntercepts()
        if lbc is None and ubc is None and lbi is None and ubi is None:
            z = np.zeros(n_coef + n_int, np.float32)
            return z, z, False
        if n_int == 0 and (lbi is not None or ubi is not None):
            raise ValueError(
                "intercept bounds require fitIntercept=True (the bound "
                "would otherwise silently constrain nothing)"
            )
        rows = 1 if binomial else k
        lb = np.full(n_coef + n_int, -np.inf, np.float64)
        ub = np.full(n_coef + n_int, np.inf, np.float64)

        def coef_part(mat, name):
            m = np.asarray(mat, np.float64)
            if m.shape != (rows, d):
                raise ValueError(
                    f"{name} must have shape ({rows}, {d}), got {m.shape}"
                )
            # theta coefficient layout is [D, rows] flattened; ±inf entries
            # stay infinite (inf * 0 would be NaN on std=0 features); a
            # finite bound on a zero-variance feature collapses to 0
            with np.errstate(invalid="ignore"):  # inf * 0 in the dead branch
                scaled = np.where(np.isinf(m), m, m * std[None, :])
            return scaled.T.reshape(-1)

        if lbc is not None:
            lb[:n_coef] = coef_part(lbc, "lowerBoundsOnCoefficients")
        if ubc is not None:
            ub[:n_coef] = coef_part(ubc, "upperBoundsOnCoefficients")
        if n_int:
            def int_part(vec, name):
                v = np.asarray(vec, np.float64).reshape(-1)
                if v.shape != (rows,):
                    raise ValueError(
                        f"{name} must have length {rows}, got {v.shape}"
                    )
                return v

            if lbi is not None:
                lb[n_coef:] = int_part(lbi, "lowerBoundsOnIntercepts")
            if ubi is not None:
                ub[n_coef:] = int_part(ubi, "upperBoundsOnIntercepts")
        if not (lb <= ub).all():
            raise ValueError("lower bounds must not exceed upper bounds")
        return lb, ub, True

    def _resolve_family(self, y, n):
        """(binomial, num_classes) with Spark's auto/validation rules."""
        num_classes = int(y.max()) + 1 if n else 2
        family = self.getFamily()
        if family == "auto":
            family = "binomial" if num_classes <= 2 else "multinomial"
        if family == "binomial" and num_classes > 2:
            raise ValueError(
                f"binomial family with {num_classes} classes; use multinomial"
            )
        return family == "binomial", max(num_classes, 2)

    @staticmethod
    def _moments_to_stats(s1, s2, cnt, cc):
        """(std, inv_std, class_counts) from one summarizer pass."""
        w_sum = max(float(cnt), 1e-12)
        mean = np.asarray(s1, np.float64) / w_sum
        var = np.maximum(np.asarray(s2, np.float64) / w_sum - mean**2, 0.0)
        std = np.sqrt(var)
        inv_std = np.divide(1.0, std, out=np.zeros_like(std), where=std > 0)
        return std, inv_std, np.maximum(np.asarray(cc, np.float64), 1e-12)

    def _prep_data(self, frame: Frame) -> dict:
        """Upload the rows to the estimator's device and summarize them."""
        X, y, w = self._extract(frame)
        n, d = X.shape
        binomial, k = self._resolve_family(y, n)
        dev = self.device
        xs = torch.from_numpy(np.require(X, requirements=["C", "W"])).to(dev)
        ys = torch.from_numpy(y.astype(np.int64)).to(dev)
        ws = torch.from_numpy(w).to(dev)
        std, inv_std, class_counts = self._moments_to_stats(
            *_lr_summarize(xs, ys, ws, k)
        )
        return {
            "xs": xs, "ys": ys, "ws": ws, "n": n, "d": d, "k": k,
            "binomial": binomial, "std": std,
            "inv_std": inv_std, "class_counts": class_counts,
            # kept for the training summary (lazy predictions frame)
            "frame": frame,
        }

    def _penalty_vectors(self, d: int, k: int, binomial: bool, inv_std):
        """Elastic-net penalty weights in the SCALED optimization space —
        the one encoding of Spark's standardization=True/False penalty
        semantics."""
        reg = self.getRegParam()
        alpha = self.getElasticNetParam()
        l2 = reg * (1.0 - alpha)
        l1 = reg * alpha
        fit_intercept = self.getFitIntercept()
        standardize = self.getStandardization()
        n_coef = d if binomial else d * k
        n_int = (1 if binomial else k) if fit_intercept else 0
        pen_scale = np.ones(d) if standardize else inv_std
        pen_l2 = np.tile(pen_scale**2, 1 if binomial else k).astype(np.float32)
        l1_vec = np.concatenate(
            [l1 * np.tile(pen_scale, 1 if binomial else k), np.zeros(n_int)]
        ).astype(np.float32)
        return {
            "l2": np.float32(l2), "pen_l2": pen_l2, "l1_vec": l1_vec,
            "use_l1": l1 > 0, "n_coef": n_coef, "n_int": n_int,
        }

    def _grid_vectors(self, prep: dict) -> dict:
        """Optimizer inputs of one fit: penalty vectors and the start
        point (prior-log-odds intercepts)."""
        d, k, binomial = prep["d"], prep["k"], prep["binomial"]
        vec = self._penalty_vectors(d, k, binomial, prep["inv_std"])
        n_coef, n_int = vec["n_coef"], vec["n_int"]
        class_counts = prep["class_counts"]
        theta0 = np.zeros(n_coef + n_int, dtype=np.float32)
        if self.getFitIntercept():
            # prior-log-odds intercept init (Spark parity)
            priors = class_counts / class_counts.sum()
            if binomial:
                theta0[n_coef] = np.log(priors[1] / priors[0]) if k == 2 else 0.0
            else:
                theta0[n_coef:] = np.log(priors)
        vec["theta0"] = theta0
        return vec

    def _theta_to_model(
        self, theta, prep, n_iters, history, use_bounds=False
    ) -> "LogisticRegressionModel":
        """Unscale + canonicalize a solution vector into a fitted model."""
        d, k, binomial = prep["d"], prep["k"], prep["binomial"]
        inv_std = prep["inv_std"]
        fit_intercept = self.getFitIntercept()
        reg = self.getRegParam()
        n_coef = d if binomial else d * k
        theta = np.asarray(theta, np.float64)
        W_scaled, b = (
            (theta[:n_coef].reshape(d, 1), theta[n_coef:])
            if binomial
            else (theta[:n_coef].reshape(d, k), theta[n_coef:])
        )
        coef_orig = W_scaled * inv_std[:, None]  # back to original space
        if binomial:
            coefficients = np.zeros((2, d))
            coefficients[1] = coef_orig[:, 0]
            intercepts = np.zeros(2)
            if fit_intercept:
                intercepts[1] = b[0]
            coef_matrix = coefficients
        else:
            coef_matrix = coef_orig.T  # [K, D]
            intercepts = np.asarray(
                b if fit_intercept else np.zeros(k), np.float64
            )
            # Spark canonicalization: the softmax is invariant to uniform
            # shifts; unpenalized intercepts are mean-centered, and with no
            # regularization the coefficients are too — skipped under
            # bound constraints (centering could leave the box), as Spark
            # does
            if fit_intercept and not use_bounds:
                intercepts = intercepts - intercepts.mean()
            if reg == 0.0 and not use_bounds:
                coef_matrix = coef_matrix - coef_matrix.mean(
                    axis=0, keepdims=True
                )

        n_iters = int(n_iters)
        model = LogisticRegressionModel(
            coefficient_matrix=coef_matrix.astype(np.float32),
            intercepts=np.asarray(intercepts, np.float32),
            is_binomial=binomial,
            device=self.device,
        )
        model.setParams(
            **{
                name: val
                for name, val in self.paramValues().items()
                if model.hasParam(name)
            }
        )
        hist = np.asarray(history)[: n_iters + 1]
        summary_cls = (
            BinaryClassificationTrainingSummary
            if binomial
            else ClassificationTrainingSummary
        )
        model.summary = summary_cls(
            hist, n_iters, model, prep["frame"], labelCol=self.getLabelCol(),
        )
        return model

    def _fit(self, frame: Frame) -> "LogisticRegressionModel":
        with full_f32():
            prep = self._prep_data(frame)
        xs, ys, ws = prep["xs"], prep["ys"], prep["ws"]
        n, d, k = prep["n"], prep["d"], prep["k"]
        binomial = prep["binomial"]
        std, inv_std = prep["std"], prep["inv_std"]

        reg = self.getRegParam()
        alpha = self.getElasticNetParam()
        fit_intercept = self.getFitIntercept()
        standardize = self.getStandardization()

        vec = self._grid_vectors(prep)
        l2, pen_l2 = vec["l2"], vec["pen_l2"]
        l1_vec, theta0 = vec["l1_vec"], vec["theta0"]
        use_l1 = vec["use_l1"]
        n_coef, n_int = vec["n_coef"], vec["n_int"]

        # ---- bound constraints (Spark's bound-constrained variant) ----
        lb_t, ub_t, use_bounds = self._build_bounds(
            d, k, binomial, n_coef, n_int, std
        )
        if use_bounds and use_l1:
            raise ValueError(
                "bound-constrained optimization only supports none/L2 "
                "regularization (Spark parity): set elasticNetParam=0"
            )
        if use_bounds and fit_intercept:
            # the prior-log-odds init must start inside the box
            theta0[n_coef:] = np.clip(
                theta0[n_coef:], lb_t[n_coef:], ub_t[n_coef:]
            )

        dev = self.device

        def on_dev(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        args = (on_dev(inv_std), on_dev(l2), on_dev(pen_l2), on_dev(l1_vec),
                on_dev(theta0))
        lb_d, ub_d = on_dev(lb_t), on_dev(ub_t)

        def opt_call(init_state, resume, iter_limit):
            return _lr_optimize(
                xs, ys, ws, *args, init_state, iter_limit, lb_d, ub_d,
                binomial=binomial,
                fit_intercept=fit_intercept,
                k=k,
                max_iter=self.getMaxIter(),
                tol=self.getTol(),
                use_l1=use_l1,
                resume=resume,
                use_bounds=use_bounds,
            )

        fingerprint = {
            "algo": "logistic_regression",
            "n_coef": n_coef, "n_int": n_int, "num_classes": k,
            "binomial": binomial, "regParam": reg, "elasticNetParam": alpha,
            "maxIter": self.getMaxIter(), "tol": self.getTol(),
            "standardization": standardize, "n_rows": n,
            "bounds": (
                _bounds_digest(lb_t, ub_t) if use_bounds else None
            ),
        }
        # imported here: mlio imports the models to load them
        from sntc_tpu_torch.mlio.optimizer_checkpoint import run_segmented

        with full_f32():
            res = run_segmented(
                opt_call,
                self.getMaxIter(),
                self.getCheckpointInterval(),
                self.getCheckpointDir(),
                fingerprint,
            )

        model = self._theta_to_model(
            res.x.cpu().numpy(), prep, res.n_iters, res.history.cpu().numpy(),
            use_bounds=use_bounds,
        )
        model.optimizer_stats = {"iterations": int(res.n_iters),
                                 "evaluations": res.n_evals,
                                 "host_syncs": res.n_syncs}
        return model


def _lr_serve(X, coefT, intercepts, thr, *, binomial, mode):
    """raw + probability + prediction packed into one ``[N, 2K+1]``
    tensor.  Probability is softmax of the ORIGINAL margins: a binomial
    model's class-0 coefficients are zero, so softmax([0, m]) is Spark's
    sigmoid(m); the raw block of a binomial model is ``[-m, m]``."""
    margins = X @ coefT + intercepts[None, :]
    prob = torch.softmax(margins, dim=1)
    if binomial:
        m = margins[:, 1] - margins[:, 0]
        raw = torch.stack([-m, m], dim=1)
    else:
        raw = margins
    return pack_serve_outputs(raw, prob, thr, mode)


class LogisticRegressionModel(_LrParams, DeviceHeadMixin, ClassificationModel):
    def __init__(
        self,
        coefficient_matrix: np.ndarray,  # [K, D] original space
        intercepts: np.ndarray,  # [K]
        is_binomial: bool,
        device="cuda",
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.coefficientMatrix = np.array(coefficient_matrix, np.float32)
        self.interceptVector = np.array(intercepts, np.float32)
        # read-only (own copy): the device copies are made once, so an
        # in-place edit would serve stale weights — make it raise instead
        self.coefficientMatrix.flags.writeable = False
        self.interceptVector.flags.writeable = False
        self.is_binomial = bool(is_binomial)
        self.summary = None
        self.optimizer_stats = None
        self.device = resolve_device(device)
        self._dev_params = (
            torch.from_numpy(self.coefficientMatrix.T.copy()).to(self.device),
            torch.from_numpy(self.interceptVector.copy()).to(self.device),
        )
        self._thr_cache = None

    def _save_extra(self):
        return (
            {"is_binomial": self.is_binomial},
            {
                "coefficientMatrix": self.coefficientMatrix,
                "interceptVector": self.interceptVector,
            },
        )

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(
            coefficient_matrix=arrays["coefficientMatrix"],
            intercepts=arrays["interceptVector"],
            is_binomial=extra["is_binomial"],
            device=device,
        )
        m.setParams(**params)
        return m

    # Spark binary-model accessors
    @property
    def coefficients(self) -> np.ndarray:
        if not self.is_binomial:
            raise AttributeError("use coefficientMatrix for multinomial models")
        return self.coefficientMatrix[1]

    @property
    def intercept(self) -> float:
        if not self.is_binomial:
            raise AttributeError("use interceptVector for multinomial models")
        return float(self.interceptVector[1])

    @property
    def num_classes(self) -> int:
        return self.coefficientMatrix.shape[0]

    def _predict_all_dev(self, X) -> torch.Tensor:
        mode, thr = self._serve_args()
        coefT, b = self._dev_params
        return _lr_serve(
            self._features_on_device(X), coefT, b, thr,
            binomial=self.is_binomial, mode=mode,
        )
