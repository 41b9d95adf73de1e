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
the estimator's device and every product in full float32.  With a
``mesh=`` of more than one shard the single fit shards its rows once:
the summarizer is one ``make_tree_aggregate`` and the objective the sum
of the shards' ``(Σ w·loss, gradient, Σw)``
(``mlp.sharded_value_and_grad``), the penalty added once; the lane
fits below shard theirs the same way, each evaluation summing the
shards' ``[L]`` lane losses, ``[L, P]`` gradients and ``[L]`` weight
sums in shard order (one ``all_reduce`` across processes), so the lane
loop's host reads do not grow with the shards.  The class
counts are a one-hot product, not a scatter of atomics, so the fit is
the same run to run.  The summarizer takes raw Σx² (not pilot-shifted,
unlike the scaler), as the JAX package does.

Many fits in one loop (the JAX package's vmapped programs): the grid
lanes (``_fit_grid``: one frame, one lane per grid point), the fold ×
grid lanes (``_fit_grid_folds``: a cross-validation fold is a 0/1 row
weight mask over the shared rows, and each lane standardizes on its own
fold) and the one-vs-rest lanes (``_fit_ovr_lanes``: lane c relabels
``ys == c``).  The rows go to the device once; every lane's smooth
objective is one product of the lanes' scaled coefficients ``[L·K, D]``
with the rows, a weighted loss per lane and one backward pass of their
sum, inside
:func:`~sntc_tpu_torch.ops.lbfgs.minimize_lbfgs_lanes`.  L1 (OWLQN) and
L2-only lanes run as two programs.  ``supports_batched_grid`` and
``supports_vectorized_ovr`` give the JAX package's verdicts.

``partial_fit`` is the JAX package's streaming update: the summarizer
pass over each mini-batch folds into exactly accumulated moments
(``lifecycle.incremental.LRPartialFitState``), and one warm-started run
of the single fit's LBFGS on the mini-batch advances the solution, which
is kept in the original feature space between calls.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.obs.cost import matmul_flops
from sntc_tpu_torch.models.base import (
    CheckpointParams,
    ClassificationModel,
    ClassifierEstimator,
    DeviceHeadMixin,
    pack_serve_outputs,
)
from sntc_tpu_torch.models.mlp import (
    local_blocks,
    sharded_value_and_grad,
    value_and_grad_fn,
)
from sntc_tpu_torch.parallel.collectives import (
    ShardedArray,
    fit_device,
    fit_mesh,
    fit_rows,
    make_tree_aggregate,
    place_rows,
    shard_batch,
)
from sntc_tpu_torch.parallel.mesh import reduce_at
from sntc_tpu_torch.models.summary import (
    BinaryClassificationTrainingSummary,
    ClassificationTrainingSummary,
    TrainingSummary,
)
from sntc_tpu_torch.ops.lbfgs import (
    full_f32,
    minimize_lbfgs,
    minimize_lbfgs_lanes,
)


def _lr_summary_vec(xs, ys, ws, k):
    onehot = torch.nn.functional.one_hot(ys, k).to(ws.dtype)
    return torch.cat([ws @ xs, ws @ (xs * xs), ws.sum().reshape(1),
                      ws @ onehot])


def _lr_summarize(xs, ys, ws, k):
    """Σw·x, Σw·x², Σw and the per-class Σw in one pass, as float64
    host arrays; the class sums are ``ws @ one_hot(ys)``.  Sharded rows
    sum the shards' passes."""
    if isinstance(xs, ShardedArray):
        vec = make_tree_aggregate(
            lambda x, y, w: _lr_summary_vec(x, y, w, k), xs.mesh,
            op="lr.summarize")(xs, ys, ws)
    else:
        vec = _lr_summary_vec(xs, ys, ws, k)
    d = xs.shape[1]
    out = vec.cpu().numpy().astype(np.float64)
    return out[:d], out[d:2 * d], out[2 * d], out[2 * d + 1:]


def _lr_lane_losses(
    theta, xs, ys_lanes, ws_lanes, inv_std, l2, pen_l2, w_sum,
    *, binomial, fit_intercept, k, n_coef,
):
    """Every lane's smooth objective ``[L]`` (the single fit is one
    lane): one product ``xs @ Wd`` of the shared rows with the lanes'
    coefficients ``[D, L·K]`` (each lane's scaled by its own
    ``inv_std``); each lane's margins then go lanes first, so that its
    sum over the rows is a contiguous reduction whatever L, and each
    lane takes its weighted mean log loss and L2 term.  ``ys_lanes`` is
    ``[N]`` (shared labels) or ``[L, N]`` (one-vs-rest relabels);
    ``ws_lanes`` ``[1, N]`` or ``[L, N]``; ``inv_std`` ``[L, D]``;
    ``l2``, ``w_sum`` ``[L]``; ``pen_l2`` ``[L, n_coef]``."""
    L = theta.shape[0]
    n, d = xs.shape
    kk = 1 if binomial else k
    coef = theta[:, :n_coef].reshape(L, d, kk)
    b = (
        theta[:, n_coef:]
        if fit_intercept
        else torch.zeros((L, kk), dtype=theta.dtype, device=theta.device)
    )
    Wd = coef * inv_std[:, :, None]  # fold scaling into the matmul
    margins = xs @ Wd.permute(1, 0, 2).reshape(d, L * kk) \
        + b.reshape(1, L * kk)
    if binomial:
        z = margins.t().contiguous()  # [L, N]
        yf = ys_lanes.to(z.dtype)
        data = torch.sum(
            ws_lanes * (torch.logaddexp(torch.zeros_like(z), z) - yf * z),
            dim=1)
    else:
        logp = torch.log_softmax(margins.reshape(n, L, kk), dim=2)
        picked = torch.gather(
            logp, 2, ys_lanes[:, None, None].expand(n, L, 1))[:, :, 0]
        data = -torch.sum(ws_lanes * picked.t().contiguous(), dim=1)
    data = data / w_sum
    penalty = 0.5 * l2 * torch.sum(pen_l2 * theta[:, :n_coef] ** 2, dim=1)
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
    if isinstance(xs, ShardedArray):
        zero, one = torch.zeros_like(l2).reshape(1), torch.ones_like(l2)

        def data_fn(theta, x, y, w):
            # a shard's Σ w·loss: the lane objective without its penalty
            # and its division by Σw
            return _lr_lane_losses(
                theta[None], x, y, w[None], inv_std[None].to(x.device),
                zero.to(x.device), pen_l2[None].to(x.device),
                one.to(x.device).reshape(1),
                binomial=binomial, fit_intercept=fit_intercept, k=k,
                n_coef=n_coef,
            )[0]

        def penalty(theta):
            return 0.5 * l2 * torch.sum(pen_l2 * theta[:n_coef] ** 2)

        value_and_grad = sharded_value_and_grad(
            xs.mesh, data_fn, local_blocks(xs, ys, ws), penalty)
    else:
        w_sum = torch.sum(ws[None], dim=1)

        def loss_fn(theta):
            # the lane objective with one lane: the single fit and the
            # lane fits evaluate the same products in the same layout
            return _lr_lane_losses(
                theta[None], xs, ys, ws[None], inv_std[None], l2.reshape(1),
                pen_l2[None], w_sum,
                binomial=binomial, fit_intercept=fit_intercept, k=k,
                n_coef=n_coef,
            )[0]

        value_and_grad = value_and_grad_fn(loss_fn)

    return minimize_lbfgs(
        value_and_grad,
        theta0,
        max_iter=max_iter,
        tol=tol,
        l1=l1_vec if use_l1 else None,
        init_state=init_state if resume else None,
        return_state=True,
        iter_limit=iter_limit,
        bounds=(lb, ub) if use_bounds else None,
    )


def _lr_folds_block(xs, ys, ws_b, k):
    """One block's per-fold moments and class sums ``[F, 2D+1+K]`` from
    its ``[F, N]`` weight masks."""
    onehot = torch.nn.functional.one_hot(ys, k).to(ws_b.dtype)
    return torch.cat([ws_b @ xs, ws_b @ (xs * xs), ws_b.sum(1, keepdim=True),
                      ws_b @ onehot], 1)


def _lr_summarize_folds(xs, ys, ws_b, k):
    """Per-fold moments and class sums from ``[F, N]`` weight masks (each
    cross-validation fold standardizes on its own train rows, as a
    sequential sub-fit would), as float64 host arrays ``[F, ...]``.
    Over sharded rows the masks are sharded with them, ``[N, F]`` (a
    fold a column), and the shards' passes are summed."""
    if isinstance(xs, ShardedArray):
        out = make_tree_aggregate(
            lambda x, y, w: _lr_folds_block(x, y, w.t().contiguous(), k),
            xs.mesh, op="lr.summarize_folds")(xs, ys, ws_b)
    else:
        out = _lr_folds_block(xs, ys, ws_b, k)
    out = out.cpu().numpy().astype(np.float64)
    d = xs.shape[1]
    return out[:, :d], out[:, d:2 * d], out[:, 2 * d], out[:, 2 * d + 1:]


def _lane_blocks(xs, ys, ws, lanes_fn):
    """The lane program's rows ``(x, ys_lanes, ws_lanes)``, the lanes'
    labels and weights from ``lanes_fn(x, y, w)``: one tuple on one
    device, or over sharded rows a list of them, one a local shard."""
    if isinstance(xs, ShardedArray):
        return [(x,) + lanes_fn(x, y, w)
                for x, y, w in zip(xs.blocks, ys.blocks, ws.blocks)]
    return (xs,) + lanes_fn(xs, ys, ws)


def _lr_lane_program(
    rows, inv_std_b, l2_b, pen_l2_b, l1_vec_b, theta0_b,
    *, binomial, fit_intercept, k, max_iter, tol, use_l1, mesh=None,
):
    """One lane-batched LBFGS/OWLQN fit: the gradient of the lanes'
    summed objectives is each lane's own gradient (the lanes share no
    parameter).  ``rows`` is ``(xs, ys_lanes, ws_lanes)`` on one device,
    or, over ``mesh``, a list of them, one a local shard: each shard's
    lanes' ``Σ w·loss [L]``, gradients ``[L, P]`` and ``Σw [L]`` are
    summed in shard order (one ``all_reduce`` across processes), then
    divided, the penalty added once."""
    if mesh is None:
        xs, ys_lanes, ws_lanes = rows
        d = xs.shape[1]
        n_coef = d if binomial else d * k
        w_sum = torch.sum(ws_lanes, dim=1)

        def value_and_grad(theta):
            t = theta.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = _lr_lane_losses(
                    t, xs, ys_lanes, ws_lanes, inv_std_b, l2_b, pen_l2_b,
                    w_sum, binomial=binomial, fit_intercept=fit_intercept,
                    k=k, n_coef=n_coef,
                )
                (g,) = torch.autograd.grad(loss.sum(), t)
            return loss.detach(), g
    else:
        d = rows[0][0].shape[1]
        n_coef = d if binomial else d * k
        L = theta0_b.shape[0]
        zero = torch.zeros_like(l2_b)
        one = torch.ones_like(l2_b)

        def value_and_grad(theta):
            parts = []
            for x, ys_l, ws_l in rows:
                dv = x.device
                t = theta.detach().to(dv).requires_grad_(True)
                with torch.enable_grad():
                    # a shard's Σ w·loss a lane: the lane objective without
                    # its penalty and its division by Σw
                    v = _lr_lane_losses(
                        t, x, ys_l, ws_l, inv_std_b.to(dv), zero.to(dv),
                        pen_l2_b.to(dv), one.to(dv), binomial=binomial,
                        fit_intercept=fit_intercept, k=k, n_coef=n_coef,
                    )
                    (g,) = torch.autograd.grad(v.sum(), t)
                w_l = ws_l.sum(dim=1).expand(L)  # shared weights: [1]
                parts.append(torch.cat([v.detach()[:, None], g,
                                        w_l[:, None]], dim=1))
            tot = reduce_at(parts, mesh=mesh).to(theta.device)
            w_sum = tot[:, -1:]
            t = theta.detach().requires_grad_(True)
            with torch.enable_grad():
                pen = 0.5 * l2_b * torch.sum(pen_l2_b * t[:, :n_coef] ** 2,
                                             dim=1)
                (gp,) = torch.autograd.grad(pen.sum(), t)
            return (tot[:, 0] / w_sum[:, 0] + pen.detach(),
                    tot[:, 1:-1] / w_sum + gp)

    return minimize_lbfgs_lanes(
        value_and_grad, theta0_b, max_iter=max_iter, tol=tol,
        l1=l1_vec_b if use_l1 else None,
    )


def _lr_optimize_grid(
    xs, ys, ws, inv_std, l2_b, pen_l2_b, l1_vec_b, theta0_b,
    *, binomial, fit_intercept, k, max_iter, tol, use_l1,
):
    """G grid points over the same rows in one lane loop: the lanes share
    the rows, their weights and the standardization, and differ in the
    penalty vectors and the start point."""
    L = theta0_b.shape[0]
    mesh = xs.mesh if isinstance(xs, ShardedArray) else None
    rows = _lane_blocks(xs, ys, ws, lambda x, y, w: (y, w[None, :]))
    return _lr_lane_program(
        rows, inv_std[None, :].expand(L, -1), l2_b, pen_l2_b,
        l1_vec_b, theta0_b, binomial=binomial, fit_intercept=fit_intercept,
        k=k, max_iter=max_iter, tol=tol, use_l1=use_l1, mesh=mesh,
    )


def _lr_optimize_lanes(
    xs, ys, ws_folds, fold_idx_b, inv_std_b, l2_b, pen_l2_b, l1_vec_b,
    theta0_b,
    *, binomial, fit_intercept, k, max_iter, tol, use_l1,
):
    """Fold × grid lanes in one loop: lane l weighs the rows by its
    fold's mask ``ws_folds[fold_idx_b[l]]`` (the masks are on the device
    once, ``[F, N]``; over a mesh sharded with the rows, ``[N, F]``) and
    carries its fold's standardization."""
    mesh = xs.mesh if isinstance(xs, ShardedArray) else None
    if mesh is None:
        rows = (xs, ys, ws_folds[fold_idx_b])
    else:
        rows = _lane_blocks(
            xs, ys, ws_folds,
            lambda x, y, w: (y, w.t().contiguous()[fold_idx_b.to(w.device)]))
    return _lr_lane_program(
        rows, inv_std_b, l2_b, pen_l2_b,
        l1_vec_b, theta0_b, binomial=binomial, fit_intercept=fit_intercept,
        k=k, max_iter=max_iter, tol=tol, use_l1=use_l1, mesh=mesh,
    )


def _lr_optimize_ovr(
    xs, ys, ws, inv_std, l2, pen_l2, l1_vec, class_ids, theta0_b,
    *, fit_intercept, max_iter, tol, use_l1,
):
    """K one-vs-rest binary fits in one loop: lane c relabels the shared
    labels ``ys == c`` on the device (on each shard's, over a mesh);
    every lane has the same penalty."""
    L = theta0_b.shape[0]
    mesh = xs.mesh if isinstance(xs, ShardedArray) else None

    def relabel(x, y, w):
        return ((class_ids.to(y.device)[:, None] == y[None, :]).to(x.dtype),
                w[None, :])

    def lanes(v):
        return v[None].expand(L, *v.shape)

    rows = _lane_blocks(xs, ys, ws, relabel)
    return _lr_lane_program(
        rows, lanes(inv_std), lanes(l2), lanes(pen_l2),
        lanes(l1_vec), theta0_b, binomial=True, fit_intercept=fit_intercept,
        k=2, max_iter=max_iter, tol=tol, use_l1=use_l1, mesh=mesh,
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


_BOUND_PARAMS = (
    "lowerBoundsOnCoefficients", "upperBoundsOnCoefficients",
    "lowerBoundsOnIntercepts", "upperBoundsOnIntercepts",
)


def _bounds_digest(lb: np.ndarray, ub: np.ndarray) -> str:
    import hashlib

    h = hashlib.md5()
    h.update(np.ascontiguousarray(lb, np.float32).tobytes())
    h.update(np.ascontiguousarray(ub, np.float32).tobytes())
    return h.hexdigest()


class LogisticRegression(_LrParams, CheckpointParams, ClassifierEstimator):
    """Fits on ``device`` (default ``cuda``), or over ``mesh`` (whose
    first local device is then the device), and returns a model whose
    coefficients live on that device."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    # ---- lane fits (CrossValidator / TrainValidationSplit / OneVsRest) ----

    _GRID_VARYING = frozenset(
        {"regParam", "elasticNetParam", "standardization"}
    )
    _GRID_UNIFORM = frozenset({"maxIter", "tol", "fitIntercept", "family"})

    def supports_batched_grid(self, param_maps) -> bool:
        """True if ``param_maps`` can run as one lane loop: every key is
        a hyperparameter the lanes accept, the loop's own knobs are
        uniform across points, and no bound constraints or mid-fit
        checkpoints are in play."""
        if len(param_maps) < 2:
            return False
        keys = set().union(*param_maps)
        if not keys <= (self._GRID_VARYING | self._GRID_UNIFORM):
            return False
        for kk in keys & self._GRID_UNIFORM:
            vals = {m.get(kk, self.paramValues().get(kk)) for m in param_maps}
            if len(vals) > 1:
                return False
        if any(
            self.paramValues().get(p) is not None for p in _BOUND_PARAMS
        ):
            return False
        return not self._would_checkpoint()

    def supports_vectorized_ovr(self) -> bool:
        """True when OneVsRest can run this classifier's K binary fits as
        one lane loop: a binomial-compatible family, no bound
        constraints, no mid-fit checkpoints."""
        if self.getFamily() == "multinomial":
            return False  # a 2-class softmax parameterization differs
        if any(
            self.paramValues().get(p) is not None for p in _BOUND_PARAMS
        ):
            return False
        return not self._would_checkpoint()

    def _would_checkpoint(self) -> bool:
        """True iff a fit would persist mid-fit state (interval AND dir
        set, the gate ``run_segmented`` uses): the lane fits defer to the
        sequential fit only then."""
        return (
            self.getCheckpointInterval() > 0
            and bool(self.getCheckpointDir())
        )

    def _lanes_to_models(self, res, ests, preps):
        """Lane l of ``res`` through ``ests[l]._theta_to_model`` with
        ``preps[l]``, each model carrying its lane's iterations and the
        program's evaluations, host reads and lane count."""
        xs_h = res.x.cpu().numpy()
        iters_h = res.n_iters.cpu().numpy()
        hist_h = res.history.cpu().numpy()
        models = []
        for lane, (est, prep) in enumerate(zip(ests, preps)):
            model = est._theta_to_model(
                xs_h[lane], prep, iters_h[lane], hist_h[lane])
            model.optimizer_stats = {
                "iterations": int(iters_h[lane]),
                "evaluations": res.n_evals, "host_syncs": res.n_syncs,
                "lanes": len(ests),
            }
            models.append(model)
        return models

    def _lane_tensors(self, vecs, key):
        """``[L, ...]`` float32 tensor on the device of each lane's
        ``key`` entry."""
        return torch.from_numpy(
            np.stack([np.asarray(v[key], np.float32) for v in vecs])
        ).to(self.device)

    def _fit_grid_folds(self, frame: Frame, param_maps, fold_of, num_folds):
        """CrossValidator's whole k-fold × grid sweep in at most two lane
        loops (L2-only and L1): a fold is a 0/1 row-weight mask over the
        shared rows, so (fold, grid point) lanes run together, the rows
        go to the device once, and each lane standardizes on its own
        fold's moments (as a sequential sub-fit does).  Returns
        ``[num_folds][G]`` fitted models."""
        ests = [self.copy(m) for m in param_maps]
        G = len(ests)
        X, y, w = self._extract(frame)
        n, d = X.shape
        binomial, k = ests[0]._resolve_family(y, n)
        dev = self.device
        mesh = fit_mesh(self.mesh)
        fold_of = np.asarray(fold_of)
        if mesh is None:
            xs = torch.from_numpy(np.require(X, requirements=["C", "W"])).to(
                dev)
            ys = torch.from_numpy(y.astype(np.int64)).to(dev)
            masks = np.zeros((num_folds, n), np.float32)
            for f in range(num_folds):
                masks[f] = (fold_of != f) * w  # zero weight = not in the fold
            ws_folds = torch.from_numpy(masks).to(dev)
        else:
            # the masks sharded with the rows (a fold a column; zero on
            # the padding)
            xs, ys, _ = shard_batch(mesh, X, y.astype(np.int64))
            masks = np.zeros((xs.shape[0], num_folds), np.float32)
            for f in range(num_folds):
                masks[:n, f] = (fold_of != f) * w
            ws_folds = place_rows(mesh, masks)
        with full_f32():
            s1, s2, cnt, cc = _lr_summarize_folds(xs, ys, ws_folds, k)
        preps = []
        for f in range(num_folds):
            std, inv_std, class_counts = self._moments_to_stats(
                s1[f], s2[f], cnt[f], cc[f]
            )
            preps.append({
                "n": n, "d": d, "k": k, "binomial": binomial, "std": std,
                "inv_std": inv_std, "class_counts": class_counts,
            })
        vecs = [
            [ests[g]._grid_vectors(preps[f]) for g in range(G)]
            for f in range(num_folds)
        ]
        models = [[None] * G for _ in range(num_folds)]
        for flag in (False, True):
            lanes = [
                (f, g)
                for f in range(num_folds)
                for g in range(G)
                if bool(vecs[f][g]["use_l1"]) == flag
            ]
            if not lanes:
                continue
            lane_vecs = [vecs[f][g] for f, g in lanes]
            with full_f32():
                res = _lr_optimize_lanes(
                    xs, ys, ws_folds,
                    torch.tensor([f for f, _ in lanes], device=dev),
                    self._lane_tensors(
                        [preps[f] for f, _ in lanes], "inv_std"),
                    self._lane_tensors(lane_vecs, "l2"),
                    self._lane_tensors(lane_vecs, "pen_l2"),
                    self._lane_tensors(lane_vecs, "l1_vec"),
                    self._lane_tensors(lane_vecs, "theta0"),
                    binomial=binomial,
                    fit_intercept=ests[0].getFitIntercept(),
                    k=k,
                    max_iter=ests[0].getMaxIter(),
                    tol=ests[0].getTol(),
                    use_l1=flag,
                )
            fitted = self._lanes_to_models(
                res, [ests[g] for _, g in lanes], [preps[f] for f, _ in lanes])
            for (f, g), model in zip(lanes, fitted):
                models[f][g] = model
        return models

    def _fit_ovr_lanes(self, X, y, w, k, mesh=None):
        """K one-vs-rest binary models from one lane loop (see
        ``_lr_optimize_ovr``): the summarizer runs once (the moments do
        not depend on the class), each lane's intercept starts at its
        class's prior log odds, and lane c's labels are relabeled on the
        device.  Over ``mesh`` (of more than one shard) the rows are
        sharded once for the summarizer and the loop."""
        n, d = X.shape
        dev = self.device
        mesh = fit_mesh(mesh)
        xs, ys, ws = fit_rows(X, y, w, dev, mesh)
        with full_f32():
            std, inv_std, class_counts = self._moments_to_stats(
                *_lr_summarize(xs, ys, ws, k)
            )
        w_sum = float(class_counts.sum())
        fit_intercept = self.getFitIntercept()
        vec = self._penalty_vectors(d, 2, True, inv_std)
        n_int = vec["n_int"]
        theta0_b = np.zeros((k, d + n_int), np.float32)
        if fit_intercept:
            # per-class prior log odds: what each sequential relabeled
            # sub-fit's _grid_vectors start would compute
            pos = class_counts / max(w_sum, 1e-12)
            theta0_b[:, d] = np.log(
                np.maximum(pos, 1e-12) / np.maximum(1.0 - pos, 1e-12)
            )

        def on_dev(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        with full_f32():
            res = _lr_optimize_ovr(
                xs, ys, ws, on_dev(inv_std), on_dev(vec["l2"]),
                on_dev(vec["pen_l2"]), on_dev(vec["l1_vec"]),
                torch.arange(k, device=dev), on_dev(theta0_b),
                fit_intercept=fit_intercept,
                max_iter=self.getMaxIter(),
                tol=self.getTol(),
                use_l1=bool(vec["use_l1"]),
            )
        prep = {"n": n, "d": d, "k": 2, "binomial": True, "std": std,
                "inv_std": inv_std}
        return self._lanes_to_models(res, [self] * k, [prep] * k)

    def _fit_grid(self, frame: Frame, param_maps):
        """Every point of ``param_maps`` over the same frame in at most
        two lane loops; one fitted model per map, in order.  The rows go
        to the device and are summarized once; L1 (OWLQN) and L2-only
        points run apart (their update rules differ)."""
        ests = [self.copy(m) for m in param_maps]
        with full_f32():
            prep = ests[0]._prep_data(frame, fit_mesh(self.mesh))
        vecs = [e._grid_vectors(prep) for e in ests]
        inv_std = torch.from_numpy(
            np.asarray(prep["inv_std"], np.float32)).to(self.device)
        models: list = [None] * len(ests)
        for flag in (False, True):
            idxs = [i for i, v in enumerate(vecs) if bool(v["use_l1"]) == flag]
            if not idxs:
                continue
            lane_vecs = [vecs[i] for i in idxs]
            with full_f32():
                res = _lr_optimize_grid(
                    prep["xs"], prep["ys"], prep["ws"], inv_std,
                    self._lane_tensors(lane_vecs, "l2"),
                    self._lane_tensors(lane_vecs, "pen_l2"),
                    self._lane_tensors(lane_vecs, "l1_vec"),
                    self._lane_tensors(lane_vecs, "theta0"),
                    binomial=prep["binomial"],
                    fit_intercept=ests[0].getFitIntercept(),
                    k=prep["k"],
                    max_iter=ests[0].getMaxIter(),
                    tol=ests[0].getTol(),
                    use_l1=flag,
                )
            fitted = self._lanes_to_models(
                res, [ests[i] for i in idxs], [prep] * len(idxs))
            for i, model in zip(idxs, fitted):
                models[i] = model
        return models

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

    def _prep_data(self, frame: Frame, mesh=None) -> dict:
        """Upload the rows to the estimator's device (or shard them
        over ``mesh``) and summarize them."""
        X, y, w = self._extract(frame)
        n, d = X.shape
        binomial, k = self._resolve_family(y, n)
        dev = self.device
        xs, ys, ws = fit_rows(X, y, w, dev, mesh)
        std, inv_std, class_counts = self._moments_to_stats(
            *_lr_summarize(xs, ys, ws, k)
        )
        return {
            "xs": xs, "ys": ys, "ws": ws, "n": n, "d": d, "k": k,
            "binomial": binomial, "std": std,
            "inv_std": inv_std, "class_counts": class_counts,
            # kept for the training summary (lazy predictions frame),
            # whose confusion matrix is summed over the fit's mesh
            "frame": frame, "mesh": mesh,
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
        if prep.get("frame") is None:
            # fold and one-vs-rest lane sub-models (preps built without
            # the source frame) keep the light record, as in the JAX
            # package
            model.summary = TrainingSummary(hist, n_iters)
            return model
        summary_cls = (
            BinaryClassificationTrainingSummary
            if binomial
            else ClassificationTrainingSummary
        )
        model.summary = summary_cls(
            hist, n_iters, model, prep["frame"], labelCol=self.getLabelCol(),
            mesh=prep.get("mesh"),
        )
        return model

    def _fit(self, frame: Frame) -> "LogisticRegressionModel":
        with full_f32():
            prep = self._prep_data(frame, fit_mesh(self.mesh))
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


    def partial_fit(self, frame: Frame, state=None, decay: float = 1.0,
                    n_classes: int = None):
        """One incremental update (the MLlib streaming recipe): fold this
        mini-batch's summarizer moments into ``state`` and advance the
        solution with a warm-started run of the single fit's LBFGS on
        it; returns ``(model, state)``.

        The moments and class counts accumulate EXACTLY (``decay`` < 1
        down-weights the history), so every call standardizes against
        all data seen.  Each call minimizes the CURRENT shard's objective
        from the previous solution, so the contract is behavioural:
        held-out predictions agree with the batch fit on iid shards.  The
        family and class count are fixed by the first call (pass
        ``n_classes`` there when the label universe is known); bound
        constraints and mid-fit checkpointing are refused."""
        from sntc_tpu_torch.lifecycle.incremental import LRPartialFitState

        if any(self.paramValues().get(p) is not None for p in _BOUND_PARAMS):
            raise ValueError("partial_fit does not support bound constraints")
        if self._would_checkpoint():
            raise ValueError(
                "partial_fit does not support mid-fit checkpointing")
        X, y, w = self._extract(frame)
        n, d = X.shape
        if state is None:
            binomial, k = self._resolve_family(y, n)
            if n_classes is not None:
                if k > int(n_classes):
                    raise ValueError(
                        f"label {int(y.max())} outside the declared "
                        f"n_classes={int(n_classes)}")
                k = max(int(n_classes), 2)
                family = self.getFamily()
                binomial = k == 2 and family != "multinomial"
                if family == "binomial" and k > 2:
                    raise ValueError(
                        f"binomial family with {k} classes; use multinomial")
            state = LRPartialFitState(d=d, k=k, binomial=binomial)
        else:
            if d != state.d:
                raise ValueError(
                    f"partial_fit feature width {d} != state's {state.d}")
            if n and int(y.max()) >= state.k:
                raise ValueError(
                    f"label {int(y.max())} outside the class set fixed at "
                    f"the first partial_fit call ({state.k} classes)")
        dev = self.device
        mesh = fit_mesh(self.mesh)
        xs, ys, ws = fit_rows(X, y, w, dev, mesh)
        with full_f32():
            s1, s2, cnt, cc = _lr_summarize(xs, ys, ws, state.k)
        state.update(s1, s2, cnt, cc, n_rows=n, decay=decay)
        std, inv_std, class_counts = self._moments_to_stats(
            state.s1, state.s2, state.cnt, state.class_counts)
        prep = {
            "xs": xs, "ys": ys, "ws": ws, "n": n, "d": d, "k": state.k,
            "binomial": state.binomial, "std": std, "inv_std": inv_std,
            "class_counts": class_counts, "frame": None,
        }
        vec = self._grid_vectors(prep)
        n_coef, n_int = vec["n_coef"], vec["n_int"]
        theta0 = vec["theta0"]
        if state.coef_orig is not None:
            # warm start: the previous ORIGINAL-space solution rescaled
            # into THIS call's standardization space
            theta0 = theta0.copy()
            theta0[:n_coef] = (state.coef_orig * std[:, None]).reshape(
                -1).astype(np.float32)
            if n_int:
                theta0[n_coef:] = state.intercepts

        def on_dev(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        z = on_dev(np.zeros(n_coef + n_int, np.float32))
        with full_f32():
            res, _opt_state = _lr_optimize(
                xs, ys, ws, on_dev(inv_std), on_dev(vec["l2"]),
                on_dev(vec["pen_l2"]), on_dev(vec["l1_vec"]), on_dev(theta0),
                None, self.getMaxIter(), z, z,
                binomial=state.binomial,
                fit_intercept=self.getFitIntercept(),
                k=state.k,
                max_iter=self.getMaxIter(),
                tol=self.getTol(),
                use_l1=bool(vec["use_l1"]),
            )
        theta = res.x.cpu().numpy().astype(np.float64)
        state.coef_orig = (theta[:n_coef].reshape(d, state.rows)
                           * inv_std[:, None])
        state.intercepts = (theta[n_coef:].astype(np.float32) if n_int
                            else np.zeros(state.rows, np.float32))
        model = self._theta_to_model(theta, prep, res.n_iters,
                                     res.history.cpu().numpy())
        model.optimizer_stats = {"iterations": int(res.n_iters),
                                 "evaluations": res.n_evals,
                                 "host_syncs": res.n_syncs}
        return model, state


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
    # host-serve crossover (models/base.py): host features of at most
    # this many rows are served on the host.  On an NVIDIA H100 80GB HBM3
    # (700 W) the host served a binary 78-feature head faster at every
    # size measured up to here, 1.9 against 2.2 ms at 65 536 rows (the
    # card's time is mostly the upload; chip_smoke.py phase 15 (c),
    # crossover_sweep)
    HOST_SERVE_ROWS = 65536

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

    def serve_flops(self, n_rows: int) -> float:
        k, d = self.coefficientMatrix.shape
        return matmul_flops(n_rows, d, k)

    def _predict_raw_prob_host(self, X: np.ndarray):
        """numpy predict for batches at or below the host-serve
        crossover (the JAX package's host path, float32): a [N, D] x
        [D, K] product costs less than the device round trip."""
        margins = X @ self.coefficientMatrix.T + self.interceptVector[None, :]
        if self.is_binomial:
            m = margins[:, 1] - margins[:, 0]
            raw = np.stack([-m, m], axis=1)
        else:
            raw = margins
        return raw, self._raw_to_probability(raw)

    def _raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        if self.is_binomial:
            # raw = [-m, +m]; Spark's probability is sigmoid(m), in the
            # form that cannot overflow exp
            m = raw[:, 1]
            e = np.exp(-np.abs(m))
            p1 = np.where(m >= 0, 1.0, e) / (1.0 + e)
            return np.stack([1.0 - p1, p1], axis=1)
        z = raw - raw.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)

    def _predict_all_dev(self, X) -> torch.Tensor:
        mode, thr = self._serve_args()
        coefT, b = self._dev_params
        return _lr_serve(
            self._features_on_device(X), coefT, b, thr,
            binomial=self.is_binomial, mode=mode,
        )
