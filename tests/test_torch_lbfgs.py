"""The port's LBFGS/OWLQN/projected-LBFGS against the JAX package's, on
the CPU, and its resumable segments.

The same float32 problems, made from a numpy seed, go through
``sntc_tpu.ops.lbfgs.minimize_lbfgs`` and
``sntc_tpu_torch.ops.lbfgs.minimize_lbfgs``: a conditioned quadratic, an
L2-regularized logistic loss, each plain, under an L1 weight (OWLQN) and
inside a box (projected LBFGS).  The two loops make the same decisions
on f32 values that agree to rounding (XLA's and PyTorch's dot products
sum in other orders), so at ``tol`` 1e-6:

* the iteration counts are equal, or one apart where the last
  relative improvement lies within f32 rounding of ``tol`` (measured:
  one case of 15, the box-constrained quadratic of seed 0, 20 against
  19);
* the objective histories agree within 1e-5 of the largest objective
  (measured: at most 5.4e-7);
* the solutions agree within 1e-4 absolute (measured: at most 4.4e-5,
  a box-constrained coordinate).

A run split by ``iter_limit`` and resumed from its state, and a fit
driven through ``run_segmented`` with a checkpoint directory, equal the
uninterrupted run bitwise (the port against itself).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sntc_tpu.ops.lbfgs import minimize_lbfgs as jax_minimize_lbfgs
from sntc_tpu_torch.mlio.optimizer_checkpoint import (
    load_state,
    run_segmented,
    save_state,
)
from sntc_tpu_torch.ops.lbfgs import full_f32, minimize_lbfgs

torch.set_num_threads(1)

HIST_RTOL = 1e-5
X_ATOL = 1e-4


def _quadratic(seed, d=12, cond=50.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    A = ((q * np.linspace(1.0, cond, d)) @ q.T).astype(np.float32)
    b = rng.normal(size=d).astype(np.float32)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    return (lambda x: 0.5 * x @ (A @ x) - b @ x,
            lambda x: 0.5 * x @ (At @ x) - bt @ x, d)


def _logistic(seed, n=400, d=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + 0.5 * rng.normal(size=n) > 0).astype(
        np.float32)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)

    def f_jax(x):
        z = X @ x
        return jnp.mean(jnp.logaddexp(0.0, z) - y * z) + 0.01 * jnp.sum(x * x)

    def f_torch(x):
        z = Xt @ x
        return (torch.mean(torch.logaddexp(torch.zeros_like(z), z) - yt * z)
                + 0.01 * torch.sum(x * x))

    return f_jax, f_torch, d


def _torch_vg(f):
    def vg(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = f(x)
            (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    return vg


def _options(kind, d, l1, box):
    if kind == "l1":
        return {"l1": np.full(d, l1, np.float32)}
    if kind == "bounds":
        return {"bounds": (np.full(d, box[0], np.float32),
                           np.full(d, box[1], np.float32))}
    return {}


def _jax_opts(o):
    return {k: tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
            else jnp.asarray(v) for k, v in o.items()}


def _torch_opts(o):
    return {k: tuple(torch.from_numpy(a) for a in v) if isinstance(v, tuple)
            else torch.from_numpy(v) for k, v in o.items()}


@pytest.mark.parametrize("kind", ["lbfgs", "l1", "bounds"])
@pytest.mark.parametrize("problem,seed", [
    ("quadratic", 0), ("quadratic", 1), ("quadratic", 2),
    ("logistic", 0), ("logistic", 1),
])
def test_minimize_lbfgs_matches_the_jax_package(problem, seed, kind):
    if problem == "quadratic":
        f_jax, f_torch, d = _quadratic(seed)
        opts = _options(kind, d, 0.3, (-0.2, 0.3))
    else:
        f_jax, f_torch, d = _logistic(seed)
        opts = _options(kind, d, 0.02, (-0.2, 0.3))
    ref = jax_minimize_lbfgs(
        lambda x: jax.value_and_grad(f_jax)(x), jnp.zeros(d, jnp.float32),
        max_iter=100, tol=1e-6, **_jax_opts(opts))
    got = minimize_lbfgs(_torch_vg(f_torch), torch.zeros(d), max_iter=100,
                         tol=1e-6, **_torch_opts(opts))
    assert abs(got.n_iters - int(ref.n_iters)) <= 1 and got.converged
    hist = np.asarray(ref.history)
    assert got.history.shape == hist.shape
    assert np.abs(got.history.numpy() - hist).max() <= HIST_RTOL * max(
        1.0, np.abs(hist).max())
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=X_ATOL)
    np.testing.assert_allclose(float(got.loss), float(ref.loss), rtol=1e-5)
    # one evaluation per line-search candidate plus the start; one read
    # per candidate plus one per iteration
    assert got.n_evals >= got.n_iters + 1
    assert got.n_syncs == got.n_evals - 1 + got.n_iters
    if kind == "bounds":
        assert (got.x.numpy() >= -0.2).all() and (got.x.numpy() <= 0.3).all()


def test_owlqn_lands_on_exact_zeros_like_the_jax_package():
    """Diagonal quadratic + L1: the soft-threshold solution, with exact
    zeros where the threshold kills a coordinate."""
    a = np.array([1.0, 2.0, 4.0, 0.5], np.float32)
    b = np.array([3.0, -0.1, 2.0, 0.05], np.float32)
    lam = 0.5
    x_star = np.sign(b) * np.maximum(np.abs(b) - lam, 0.0) / a
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = minimize_lbfgs(
        _torch_vg(lambda x: torch.sum(0.5 * at * x * x - bt * x)),
        torch.zeros(4), max_iter=200, tol=1e-10,
        l1=torch.full((4,), lam))
    ref = jax_minimize_lbfgs(
        lambda x: jax.value_and_grad(
            lambda x: jnp.sum(0.5 * a * x * x - b * x))(x),
        jnp.zeros(4, jnp.float32), max_iter=200, tol=1e-10,
        l1=jnp.full(4, lam, jnp.float32))
    np.testing.assert_allclose(got.x.numpy(), x_star, atol=1e-3)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=1e-6)
    assert got.x[1] == 0.0 and got.x[3] == 0.0


def test_history_pads_with_the_final_objective():
    _, f_torch, d = _quadratic(4)
    res = minimize_lbfgs(_torch_vg(f_torch), torch.zeros(d), max_iter=60,
                         tol=1e-6)
    assert res.converged and res.n_iters < 60
    hist = res.history.numpy()
    assert (hist[res.n_iters:] == float(res.loss)).all()
    assert (np.diff(hist[: res.n_iters + 1]) <= 1e-5).all()


def test_l1_and_bounds_are_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        minimize_lbfgs(_torch_vg(lambda x: torch.sum(x * x)), torch.ones(3),
                       l1=torch.ones(3),
                       bounds=(-torch.ones(3), torch.ones(3)))


def test_full_f32_restores_the_callers_matmul_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with full_f32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("kind", ["lbfgs", "l1", "bounds"])
def test_resume_from_a_split_run_is_bitwise(kind):
    _, f_torch, d = _quadratic(5)
    opts = _torch_opts(_options(kind, d, 0.3, (-0.2, 0.3)))
    vg = _torch_vg(f_torch)
    full = minimize_lbfgs(vg, torch.zeros(d), max_iter=40, tol=0.0, **opts)
    _, half = minimize_lbfgs(vg, torch.zeros(d), max_iter=40, tol=0.0,
                             iter_limit=17, return_state=True, **opts)
    assert int(half["k"]) == 17
    resumed = minimize_lbfgs(vg, torch.zeros(d), max_iter=40, tol=0.0,
                             init_state=half, **opts)
    assert resumed.n_iters == full.n_iters
    assert torch.equal(resumed.x, full.x)
    assert torch.equal(resumed.history, full.history)


def _segmented_quadratic(ckpt_dir, interval, fingerprint):
    _, f_torch, d = _quadratic(6)
    vg = _torch_vg(f_torch)

    def opt_call(init_state, resume, iter_limit):
        return minimize_lbfgs(
            vg, torch.zeros(d), max_iter=30, tol=0.0,
            init_state=init_state if resume else None, return_state=True,
            iter_limit=iter_limit)

    return run_segmented(opt_call, 30, interval, ckpt_dir, fingerprint)


def test_run_segmented_with_checkpoints_is_bitwise(tmp_path):
    fp = {"algo": "quadratic", "seed": 6}
    plain = _segmented_quadratic(None, -1, fp)
    ckpt = str(tmp_path / "ckpt")
    seg = _segmented_quadratic(ckpt, 7, fp)
    assert seg.n_iters == plain.n_iters == 30
    assert torch.equal(seg.x, plain.x)
    assert torch.equal(seg.history, plain.history)
    assert seg.n_evals == plain.n_evals
    # a completed fit leaves no state behind
    assert load_state(ckpt, fp) is None


def test_run_segmented_resumes_a_saved_state(tmp_path):
    """A fit that stopped after a segment (its state saved) resumes from
    that state and ends where an uninterrupted fit ends; a state saved
    under another fingerprint is ignored."""
    fp = {"algo": "quadratic", "seed": 6}
    _, f_torch, d = _quadratic(6)
    vg = _torch_vg(f_torch)
    _, state = minimize_lbfgs(vg, torch.zeros(d), max_iter=30, tol=0.0,
                              iter_limit=12, return_state=True)
    from sntc_tpu_torch.ops.lbfgs import state_to_host

    ckpt = str(tmp_path / "ckpt")
    save_state(ckpt, state_to_host(state), fp)
    resumed = _segmented_quadratic(ckpt, 7, fp)
    plain = _segmented_quadratic(None, -1, fp)
    assert torch.equal(resumed.x, plain.x)
    assert resumed.n_evals < plain.n_evals  # 12 iterations were not redone
    save_state(ckpt, state_to_host(state), {"algo": "other"})
    again = _segmented_quadratic(ckpt, 7, fp)
    assert torch.equal(again.x, plain.x) and again.n_evals == plain.n_evals


@pytest.mark.cuda
def test_resume_on_the_card_is_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.normal(size=(20000, 78)).astype(np.float32)).cuda()
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).float()

    def f(w):
        z = X @ w
        return torch.mean(torch.logaddexp(torch.zeros_like(z), z) - y * z)

    vg = _torch_vg(f)
    x0 = torch.zeros(78, device="cuda")
    with full_f32():
        full = minimize_lbfgs(vg, x0, max_iter=40, tol=0.0)
        _, half = minimize_lbfgs(vg, x0, max_iter=40, tol=0.0, iter_limit=13,
                                 return_state=True)
        resumed = minimize_lbfgs(vg, x0, max_iter=40, tol=0.0,
                                 init_state=half)
        again = minimize_lbfgs(vg, x0, max_iter=40, tol=0.0)
    assert torch.equal(full.x, again.x)  # run to run
    assert torch.equal(resumed.x, full.x)
    assert torch.equal(resumed.history, full.history)
