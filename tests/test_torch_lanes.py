"""The port's lane-batched LBFGS and LogisticRegression's lane fits
against the JAX package's lane programs and against the port's own
one-at-a-time fits, on the CPU.

The same seeded numpy inputs go through:

* ``minimize_lbfgs_lanes`` and the port's single-lane ``minimize_lbfgs``
  run lane by lane: L2 and L1 (OWLQN) lanes, lanes that stop at
  different iterations (one converges at iteration 3 or 4 beside lanes
  that run to ``max_iter``), a lane whose objective is linear (no curvature
  pair ever passes ``s·y > 1e-10``) and a lane that stalls;
* the three LR lane fits, ``_fit_grid``, ``_fit_grid_folds`` (per-fold
  standardization) and ``_fit_ovr_lanes`` (prior-log-odds intercepts
  per class), against the JAX package's (its ``_lr_optimize_grid``,
  ``_lr_optimize_lanes`` and ``_lr_optimize_ovr`` on the 8-device CPU
  mesh, as ``tests/test_tuning.py`` runs them) and against the port's
  single fits of the same problems.

Tolerances (measured values from this file's inputs on the CPU):

* objective histories within 1e-5 of the starting objective over the
  first 10 iterations, the single fit's tolerance
  (``tests/test_torch_logistic.py``).  Measured: at most 3.6e-6 against
  the JAX package's lanes and 3.1e-6 against the port's single fits.
  1e-6 cannot hold on these inputs: the two packages' single fits
  already part by 3.4e-6 (the JAX package sums per shard of an 8-device
  mesh, the port in one reduction, and the lanes in a product as wide
  as their count);
* iteration counts equal, or apart only where the shorter run stopped
  on a relative improvement within f32 rounding of ``tol`` (4 ulps; one
  run's stop can then be the other's next step, and a step past the
  edge can take more than one iteration: measured 10 against 8 on the
  elastic-net grid point).  Then the final objectives agree within 1e-5
  of the start instead of the coefficients;
* coefficients within 1.3e-4 where the optimum is well determined
  (regParam >= 1e-2) and the counts are equal (measured: at most
  1.1e-4, at regParam 1.0, where the JAX package's lanes and single fit
  part by as much), intercepts within 5e-4 (measured: 3.3e-4 at
  regParam 1.0, where the JAX package's own lane and single fit part by
  3.3e-4 too: the unpenalized intercept is flat there at ``tol``);
  predictions equal on at least 99.5 % of rows (measured: at least
  99.87 %).
"""

import numpy as np
import pytest
import torch

from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.models import LogisticRegression as JLR
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.models import LogisticRegression
from sntc_tpu_torch.ops.lbfgs import minimize_lbfgs, minimize_lbfgs_lanes
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

HIST_TOL = 1e-5
HIST_PREFIX = 10
COEF_ATOL = 1.3e-4
INT_ATOL = 5e-4
PRED_AGREE = 0.995
MAX_ITER = 30


def _data(n=1500, d=6, k=2, seed=3):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * rng.uniform(0.5, 4.0, d)
         + rng.normal(size=d)).astype(np.float32)
    W = rng.normal(size=(d, k))
    y = np.argmax(X @ W + 0.5 * rng.normal(size=(n, k)), axis=1)
    return X, y.astype(np.float64)


@pytest.fixture(scope="module")
def binary():
    return _data(k=2, seed=3)


@pytest.fixture(scope="module")
def multiclass():
    return _data(k=4, seed=6)


def _frames(X, y):
    cols = {"features": X, "label": y}
    return JFrame(dict(cols)), Frame(dict(cols))


def _stopped_at_edge(hist: np.ndarray, n: int, tol: float) -> bool:
    """Whether a run that stopped at iteration ``n`` did so on a relative
    improvement within f32 rounding (4 ulps) of ``tol``."""
    h0, h1 = float(hist[n - 1]), float(hist[n])
    rel = abs(h1 - h0) / max(abs(h0), abs(h1), 1e-12)
    return abs(rel - tol) <= 4 * np.finfo(np.float32).eps


def _hold(got, want, regs, X, *, tol=1e-6):
    """Model lists against each other at the module's tolerances."""
    assert len(got) == len(want)
    for g, w, reg in zip(got, want, regs):
        hg = np.asarray(g.summary.objectiveHistory, np.float64)
        hw = np.asarray(w.summary.objectiveHistory, np.float64)
        start = abs(hw[0])
        n = min(len(hg), len(hw), HIST_PREFIX + 1)
        assert np.abs(hg[:n] - hw[:n]).max() <= HIST_TOL * start
        ig, iw = g.summary.totalIterations, w.summary.totalIterations
        if ig == iw:
            if reg >= 1e-2:
                np.testing.assert_allclose(
                    g.coefficientMatrix, w.coefficientMatrix, atol=COEF_ATOL)
                np.testing.assert_allclose(
                    g.interceptVector, w.interceptVector, atol=INT_ATOL)
        else:
            short = hg if ig < iw else hw
            assert _stopped_at_edge(short, min(ig, iw), tol)
            assert abs(hg[-1] - hw[-1]) <= HIST_TOL * start
        zg = X @ np.asarray(g.coefficientMatrix, np.float64).T \
            + g.interceptVector
        zw = X @ np.asarray(w.coefficientMatrix, np.float64).T \
            + w.interceptVector
        agree = np.mean(zg.argmax(1) == zw.argmax(1))
        assert agree >= PRED_AGREE


# -- minimize_lbfgs_lanes against the single-lane loop ----------------------


def _lane_problems(seed=0, n=400, d=5):
    """Per-lane smooth objectives over [d + 1] parameters: logistic losses
    under two L2 weights, a unit quadratic (converged by iteration 4: its
    second step is exact) and a linear objective, whose gradient never
    changes."""
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    y = torch.from_numpy(
        (X[:, 0].numpy() + 0.5 * rng.normal(size=n) > 0).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=d + 1).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=d + 1).astype(np.float32))

    def logistic(reg):
        def f(t):
            z = X @ t[:d] + t[d]
            return torch.mean(torch.logaddexp(torch.zeros_like(z), z)
                              - y * z) + 0.5 * reg * torch.sum(t[:d] ** 2)
        return f

    return [logistic(1e-2), lambda t: 0.5 * torch.sum((t - a) ** 2),
            lambda t: torch.sum(c * t), logistic(0.0)], d + 1


def _vg(f):
    def value_and_grad(x):
        t = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = f(t)
            (g,) = torch.autograd.grad(v, t)
        return v.detach(), g
    return value_and_grad


def _lanes_vg(fs):
    def value_and_grad(X):
        out = [_vg(f)(X[i]) for i, f in enumerate(fs)]
        return (torch.stack([v for v, _ in out]),
                torch.stack([g for _, g in out]))
    return value_and_grad


@pytest.mark.parametrize("use_l1", [False, True], ids=["lbfgs", "owlqn"])
def test_lanes_match_single_lane_runs(use_l1):
    fs, p = _lane_problems()
    L = len(fs)
    x0 = torch.zeros((L, p))
    l1 = None
    if use_l1:
        l1 = torch.full((L, p), 1e-2)
        l1[:, -1] = 0.0  # the intercept is never penalized
    res = minimize_lbfgs_lanes(_lanes_vg(fs), x0, max_iter=MAX_ITER, l1=l1)
    iters = res.n_iters.tolist()
    # the lanes stop apart: the quadratic first, the linear lane last
    assert iters[1] <= 4 < min(iters[0], iters[3]) and iters[2] == MAX_ITER
    for i, f in enumerate(fs):
        one = minimize_lbfgs(_vg(f), x0[i], max_iter=MAX_ITER,
                             l1=None if l1 is None else l1[i])
        assert one.n_iters == iters[i]
        assert bool(res.converged[i]) == one.converged
        np.testing.assert_allclose(res.history[i].numpy(),
                                   one.history.numpy(), rtol=0, atol=1e-6)
        # the lane and the single run reduce in other orders; at tol 1e-6
        # the flattest coordinate stops 1.8e-4 apart (the L1 lane of
        # weight 1e-2, a coefficient of 2.55)
        np.testing.assert_allclose(res.x[i].numpy(), one.x.numpy(),
                                   rtol=0, atol=5e-4)
        np.testing.assert_allclose(float(res.loss[i]), float(one.loss),
                                   rtol=1e-6)


def test_finished_lane_state_is_frozen():
    """A lane that converged at iteration 4 keeps its point and history
    while its neighbours run on: its result equals a run of that lane
    alone bitwise."""
    fs, p = _lane_problems()
    x0 = torch.zeros((len(fs), p))
    res = minimize_lbfgs_lanes(_lanes_vg(fs), x0, max_iter=MAX_ITER)
    alone = minimize_lbfgs_lanes(_lanes_vg(fs[1:2]), x0[1:2],
                                 max_iter=MAX_ITER)
    assert int(res.n_iters[1]) == 4 and int(alone.n_iters[0]) == 4
    assert torch.equal(res.x[1], alone.x[0])
    assert torch.equal(res.history[1], alone.history[0])
    assert torch.all(res.history[1, 4:] == res.history[1, 4])


def test_lane_without_curvature_pair():
    """The linear lane never stores a pair: every step is the first
    iteration's ``min(1, 1/Σ|pg|)`` along the gradient, as alone."""
    fs, p = _lane_problems()
    x0 = torch.zeros((len(fs), p))
    res = minimize_lbfgs_lanes(_lanes_vg(fs), x0, max_iter=MAX_ITER)
    c = _lane_problems()[0][2]
    g = _vg(c)(x0[2])[1]
    step = g / g.abs().sum()
    want = -MAX_ITER * step
    np.testing.assert_allclose(res.x[2].numpy(), want.numpy(), atol=1e-5)


def test_stalled_lane_stops_and_keeps_its_point():
    """A lane whose every candidate fails the Armijo test (a cliff beside
    its start, 3 tries) stalls after one iteration with its start kept;
    the other lanes run on, and each equals its single-lane run."""
    fs, p = _lane_problems()
    smooth = fs[0]

    def cliff(t):
        return smooth(t) + 1e6 * torch.sum(t.abs())

    lanes = [smooth, cliff]
    x0 = torch.zeros((2, p))
    res = minimize_lbfgs_lanes(_lanes_vg(lanes), x0, max_iter=MAX_ITER,
                               max_linesearch=3)
    assert int(res.n_iters[1]) == 1 and bool(res.converged[1])
    assert torch.equal(res.x[1], x0[1])
    for i, f in enumerate(lanes):
        one = minimize_lbfgs(_vg(f), x0[i], max_iter=MAX_ITER,
                             max_linesearch=3)
        assert one.n_iters == int(res.n_iters[i])
        np.testing.assert_allclose(res.history[i].numpy(),
                                   one.history.numpy(), atol=1e-6)


def test_host_reads_do_not_grow_with_lanes(binary):
    """2 lanes and 8 lanes (the same 2, four times) read the device the
    same number of times: one verdict vector per line-search round and
    one pair vector per iteration, whatever L."""
    X, y = binary
    _, f = _frames(X, y)
    lr = LogisticRegression(device="cpu", maxIter=MAX_ITER)
    grid = [{"regParam": 1e-2}, {"regParam": 0.0}]
    two = lr._fit_grid(f, grid)
    eight = lr._fit_grid(f, grid * 4)
    syncs2 = {m.optimizer_stats["host_syncs"] for m in two}
    syncs8 = {m.optimizer_stats["host_syncs"] for m in eight}
    assert len(syncs2) == 1 and syncs2 == syncs8
    assert {m.optimizer_stats["lanes"] for m in eight} == {8}
    for a, b in zip(two * 4, eight):
        assert np.array_equal(a.coefficientMatrix, b.coefficientMatrix)


# -- LogisticRegression's lane fits against the JAX package's ----------------

GRID = [
    {"regParam": 1e-2},
    {"regParam": 0.1, "elasticNetParam": 0.5},
    {"regParam": 1.0},
    {"regParam": 1e-2, "elasticNetParam": 1.0},
    {"regParam": 1e-2, "standardization": False},
    {"regParam": 1e-3},
]


@pytest.fixture(scope="module")
def grid_fits(binary, mesh8):
    X, y = binary
    jf, f = _frames(X, y)
    jax_models = JLR(mesh=mesh8, maxIter=MAX_ITER)._fit_grid(jf, GRID)
    lr = LogisticRegression(device="cpu", maxIter=MAX_ITER)
    return X, f, lr, jax_models, lr._fit_grid(f, GRID)


def test_fit_grid_matches_jax(grid_fits):
    X, _, _, jax_models, port = grid_fits
    _hold(port, jax_models, [g["regParam"] for g in GRID], X)
    # L1 and L2 points run as two lane loops, returned in grid order
    assert [m.optimizer_stats["lanes"] for m in port] == [4, 2, 4, 2, 4, 4]
    for params, m in zip(GRID, port):
        assert m.getRegParam() == params["regParam"]


def test_fit_grid_matches_single_fits(grid_fits):
    X, f, lr, _, port = grid_fits
    single = [lr.copy(p).fit(f) for p in GRID]
    _hold(port, single, [g["regParam"] for g in GRID], X)


FOLD_GRID = [{"regParam": 1e-2}, {"regParam": 0.05, "elasticNetParam": 1.0}]


@pytest.fixture(scope="module")
def fold_fits(multiclass, mesh8):
    X, y = multiclass
    jf, f = _frames(X, y)
    fold_of = np.random.default_rng(3).integers(0, 3, size=len(y))
    jax_models = JLR(mesh=mesh8, maxIter=MAX_ITER)._fit_grid_folds(
        jf, FOLD_GRID, fold_of, 3)
    lr = LogisticRegression(device="cpu", maxIter=MAX_ITER)
    return (X, f, lr, fold_of, jax_models,
            lr._fit_grid_folds(f, FOLD_GRID, fold_of, 3))


def test_fit_grid_folds_matches_jax(fold_fits):
    X, _, _, _, jax_models, port = fold_fits
    assert len(port) == 3 and all(len(row) == 2 for row in port)
    for p_row, j_row in zip(port, jax_models):
        _hold(p_row, j_row, [g["regParam"] for g in FOLD_GRID], X)
    # 3 L2 lanes and 3 L1 lanes
    assert {m.optimizer_stats["lanes"] for row in port for m in row} == {3}


def test_fit_grid_folds_matches_per_fold_fits(fold_fits):
    """A fold is a zero-weight mask: each lane standardizes on its fold's
    rows and equals the single fit on that fold's rows."""
    X, f, lr, fold_of, _, port = fold_fits
    for fold in range(3):
        train = f.filter(fold_of != fold)
        single = [lr.copy(p).fit(train) for p in FOLD_GRID]
        _hold(port[fold], single, [g["regParam"] for g in FOLD_GRID], X)


@pytest.fixture(scope="module")
def ovr_fits(multiclass, mesh8):
    X, y = multiclass
    yi = y.astype(np.int32)
    w = np.ones(len(y), np.float32)
    jax_models = JLR(mesh=mesh8, maxIter=MAX_ITER, regParam=1e-2)\
        ._fit_ovr_lanes(X, yi, w, 4, mesh8)
    lr = LogisticRegression(device="cpu", maxIter=MAX_ITER, regParam=1e-2)
    return X, y, lr, jax_models, lr._fit_ovr_lanes(X, yi, w, 4)


def test_fit_ovr_lanes_matches_jax(ovr_fits):
    X, _, _, jax_models, port = ovr_fits
    _hold(port, jax_models, [1e-2] * 4, X)
    assert {m.optimizer_stats["lanes"] for m in port} == {4}


def test_fit_ovr_lanes_matches_relabelled_single_fits(ovr_fits):
    """Lane c is the binary fit of ``label == c``, its intercept started
    at that class's prior log odds."""
    X, y, lr, _, port = ovr_fits
    single = []
    for c in range(4):
        f = Frame({"features": X, "bin": (y == c).astype(np.float64)})
        single.append(lr.copy({"labelCol": "bin"}).fit(f))
    _hold(port, single, [1e-2] * 4, X)


@pytest.mark.cuda
def test_lane_fits_on_the_card(binary, multiclass):
    """The grid, fold and one-vs-rest lanes on the card against the
    port's single fits on the card, at the same tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    X, y = binary
    f = Frame({"features": X, "label": y})
    lr = LogisticRegression(device="cuda", maxIter=MAX_ITER)
    port = lr._fit_grid(f, GRID)
    _hold(port, [lr.copy(p).fit(f) for p in GRID],
          [g["regParam"] for g in GRID], X)
    Xm, ym = multiclass
    fm = Frame({"features": Xm, "label": ym})
    fold_of = np.random.default_rng(3).integers(0, 3, size=len(ym))
    folds = lr._fit_grid_folds(fm, FOLD_GRID, fold_of, 3)
    for fold in range(3):
        train = fm.filter(fold_of != fold)
        _hold(folds[fold], [lr.copy(p).fit(train) for p in FOLD_GRID],
              [g["regParam"] for g in FOLD_GRID], Xm)
    base = LogisticRegression(device="cuda", maxIter=MAX_ITER, regParam=1e-2)
    lanes = base._fit_ovr_lanes(Xm, ym.astype(np.int32),
                                np.ones(len(ym), np.float32), 4)
    single = [base.copy({"labelCol": "bin"}).fit(Frame({
        "features": Xm, "bin": (ym == c).astype(np.float64)}))
        for c in range(4)]
    _hold(lanes, single, [1e-2] * 4, Xm)
