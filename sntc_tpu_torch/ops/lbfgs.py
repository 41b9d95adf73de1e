"""LBFGS / OWLQN / projected-LBFGS minimizer over torch tensors.

Counterpart of ``sntc_tpu/ops/lbfgs.py`` (the Breeze optimizer analog
behind every LR and MLP fit): history 10 in circular buffers, Armijo
backtracking (c1 1e-4, 30 tries, a first step of ``min(1, 1/Σ|pg|)``),
OWLQN's pseudo-gradient and orthant projection under a per-coordinate
``l1`` weight (Andrew & Gao 2007), projected LBFGS under ``bounds``,
curvature pairs kept only where ``s·y > 1e-10``, and a stop on relative
improvement below ``tol``.

The JAX package runs the loop as one XLA ``while_loop``; here the loop
is Python over tensors on ``x0``'s device.  Every vector operation stays
on that device; the host reads back one boolean per line-search
candidate (its Armijo verdict) and one pair per iteration (the curvature
test and the convergence test).  :class:`LbfgsResult` counts those reads
(``n_syncs``) and the ``value_and_grad`` calls (``n_evals``).

Each line-search candidate is evaluated with its gradient, as in the
JAX package, so the accepted point's gradient is the candidate's own:
one ``value_and_grad`` per candidate, none after the accept.

Resumable: ``return_state=True`` also returns the optimizer state
(position, gradient, curvature memory, counters, objective history);
passed back as ``init_state`` it continues exactly where the run
stopped, and the resumed trajectory is bitwise the uninterrupted one on
the same device.  ``iter_limit`` stops a segment at an absolute
iteration count; ``max_iter`` sizes the ``[max_iter + 1]`` objective
history, padded past the last iteration with the final objective.

Products run at the caller's matmul precision: the fits wrap the whole
optimization in :func:`full_f32` (the JAX package's ``HIGHEST``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


class LbfgsResult(NamedTuple):
    x: torch.Tensor
    loss: torch.Tensor  # final objective (incl. l1 term)
    n_iters: int  # iterations actually taken
    history: torch.Tensor  # [max_iter + 1] objective per iteration (padded with last)
    converged: bool
    n_evals: int  # value_and_grad calls
    n_syncs: int  # device->host reads of the loop's decisions


@contextlib.contextmanager
def full_f32():
    """Run float32 matrix products in full float32 (no TF32) inside the
    block, and restore the caller's setting after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _pseudo_gradient(x, g, l1):
    """OWLQN pseudo-gradient of f(x) + sum(l1 * |x|)."""
    gp = g + l1 * torch.sign(x)
    right = g + l1
    left = g - l1
    at_zero = torch.where(
        right < 0, right, torch.where(left > 0, left, torch.zeros_like(g))
    )
    return torch.where(x != 0, gp, at_zero)


def state_to_host(state: Dict) -> Dict[str, np.ndarray]:
    """The optimizer state as numpy arrays (what a checkpoint stores)."""
    return {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v)
        for k, v in state.items()
    }


def minimize_lbfgs(
    value_and_grad: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    *,
    max_iter: int = 100,
    tol: float = 1e-6,
    history_size: int = 10,
    l1: Optional[torch.Tensor] = None,
    max_linesearch: int = 30,
    c1: float = 1e-4,
    init_state: Optional[Dict] = None,
    return_state: bool = False,
    iter_limit: Optional[int] = None,
    bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Minimize ``f(x) + sum(l1 * |x|)`` where ``value_and_grad`` gives
    the smooth part's value (a 0-dim tensor) and gradient.  ``l1=None``
    is plain LBFGS, otherwise OWLQN; ``bounds=(lb, ub)`` (±inf allowed,
    exclusive with ``l1``) is projected LBFGS: coordinates at an active
    bound whose gradient pushes outward are frozen out of the direction,
    and every candidate is clipped into the box.

    ``init_state`` (tensors or numpy arrays, as ``return_state`` gave
    them or a checkpoint stored them) resumes a run; ``k`` in the state
    is the absolute iteration count and the loop runs while ``k <
    min(iter_limit, max_iter)``."""
    dev, dt = x0.device, x0.dtype
    d = x0.shape[0]
    m = history_size
    use_l1 = l1 is not None
    use_bounds = bounds is not None
    if use_l1 and use_bounds:
        raise ValueError("l1 and bounds are mutually exclusive (Spark parity)")

    def vec(a):
        return torch.as_tensor(a, dtype=dt).to(dev)

    l1v = torch.zeros(d, dtype=dt, device=dev) if l1 is None else vec(l1)
    if use_bounds:
        lb, ub = vec(bounds[0]), vec(bounds[1])
        x0 = torch.clamp(x0, lb, ub)
    counts = {"evals": 0, "syncs": 0}

    def evaluate(x):
        counts["evals"] += 1
        return value_and_grad(x)

    def read(t: torch.Tensor):
        """One device->host read of a decision."""
        counts["syncs"] += 1
        return t.tolist()

    def free_mask(x, g):
        at_lo = (x <= lb) & (g > 0)
        at_hi = (x >= ub) & (g < 0)
        return ~(at_lo | at_hi)

    def full_obj(x, f_smooth):
        if use_l1:
            return f_smooth + torch.sum(l1v * torch.abs(x))
        return f_smooth

    def effective_grad(x, g):
        if use_l1:
            return _pseudo_gradient(x, g, l1v)
        if use_bounds:
            return torch.where(free_mask(x, g), g, torch.zeros_like(g))
        return g

    def project_orthant(x_new, xi):
        if use_l1:
            keep = torch.sign(x_new) == xi
            # unpenalized coords (l1 == 0) are never clipped
            return torch.where((l1v == 0) | keep, x_new,
                               torch.zeros_like(x_new))
        return x_new

    def own(v):
        """A copy on ``dev`` of a state entry: the loop writes into the
        history buffers in place."""
        if isinstance(v, torch.Tensor):
            return v.detach().to(dev, copy=True)
        return torch.tensor(np.asarray(v), device=dev)

    if init_state is not None:
        st = {k: own(init_state[k])
              for k in ("x", "f", "obj", "g", "s_hist", "y_hist", "rho")}
        x, f, obj, g = st["x"], st["f"], st["obj"], st["g"]
        s_hist, y_hist, rho = st["s_hist"], st["y_hist"], st["rho"]
        k = int(np.asarray(init_state["k"]))
        n_upd = int(np.asarray(init_state["n_upd"]))
        # the stored history may be shorter/longer than this run's horizon
        old = own(init_state["history"])
        history = obj.reshape(1).repeat(max_iter + 1)
        n_copy = min(old.shape[0], max_iter + 1)
        history[:n_copy] = old[:n_copy]
        # a resume request re-arms the loop
    else:
        x = x0
        f, g = evaluate(x0)
        obj = full_obj(x0, f)
        history = obj.reshape(1).repeat(max_iter + 1)
        s_hist = torch.zeros((m, d), dtype=dt, device=dev)
        y_hist = torch.zeros((m, d), dtype=dt, device=dev)
        rho = torch.zeros(m, dtype=dt, device=dev)
        k = 0
        n_upd = 0
    done = False

    def two_loop(pg):
        """Two-loop recursion over the valid slots of the circular
        history, newest first (an empty slot would add exact zeros)."""
        q = pg
        n_valid = min(n_upd, m)
        alphas = []
        for i in range(n_valid):
            j = (n_upd - 1 - i) % m
            a = rho[j] * torch.dot(s_hist[j], q)
            q = q - a * y_hist[j]
            alphas.append(a)
        if n_upd > 0:
            newest = (n_upd - 1) % m
            sy = torch.dot(s_hist[newest], y_hist[newest])
            yy = torch.dot(y_hist[newest], y_hist[newest])
            q = torch.where(yy > 0, sy / yy, torch.ones_like(sy)) * q
        for i in reversed(range(n_valid)):  # oldest -> newest
            j = (n_upd - 1 - i) % m
            b = rho[j] * torch.dot(y_hist[j], q)
            q = q + s_hist[j] * (alphas[i] - b)
        return -q  # descent direction

    def line_search(direction, pg):
        """Armijo backtracking; under L1 the steps are orthant-projected
        and, under L1 or bounds, the sufficient-decrease test uses the
        actual (projected) displacement."""
        xi = torch.where(x != 0, torch.sign(x), torch.sign(-pg))
        gd = torch.dot(pg, direction)
        # first iteration: conservative step (Breeze convention)
        if n_upd > 0:
            alpha = torch.ones((), dtype=dt, device=dev)
        else:
            alpha = torch.clamp(
                1.0 / torch.clamp_min(torch.sum(torch.abs(pg)), 1e-12),
                max=1.0,
            )
        for _ in range(max_linesearch):
            x_cand = project_orthant(x + alpha * direction, xi)
            if use_bounds:
                x_cand = torch.clamp(x_cand, lb, ub)
            f_cand, g_cand = evaluate(x_cand)
            obj_cand = full_obj(x_cand, f_cand)
            if use_l1 or use_bounds:
                decrease = c1 * torch.dot(pg, x_cand - x)
            else:
                decrease = c1 * alpha * gd
            if read(obj_cand <= obj + decrease):
                return True, x_cand, f_cand, obj_cand, g_cand
            alpha = alpha * 0.5
        return False, x, f, obj, g

    limit = max_iter if iter_limit is None else min(int(iter_limit), max_iter)
    while not done and k < limit:
        pg = effective_grad(x, g)
        direction = two_loop(pg)
        if use_l1:
            # constrain direction to the descent orthant (Andrew & Gao eq. 4)
            direction = torch.where(direction * pg < 0, direction,
                                    torch.zeros_like(direction))
        if use_bounds:
            # frozen coordinates stay put; the rest clip in the line search
            direction = torch.where(free_mask(x, g), direction,
                                    torch.zeros_like(direction))
        ok, x_new, f_new, obj_new, g_new = line_search(direction, pg)
        k += 1
        if not ok:  # stalled: nothing moves, the loop ends
            history[k] = obj
            done = True
            break
        s = x_new - x
        # curvature pairs always use the SMOOTH gradient difference
        yv = g_new - g
        sy = torch.dot(s, yv)
        rel_impr = torch.abs(obj_new - obj) / torch.clamp_min(
            torch.maximum(torch.abs(obj_new), torch.abs(obj)), 1e-12
        )
        good_pair, converged = read(torch.stack([sy > 1e-10, rel_impr < tol]))
        if good_pair:
            slot = n_upd % m
            s_hist[slot] = s
            y_hist[slot] = yv
            rho[slot] = 1.0 / sy
            n_upd += 1
        x, f, obj, g = x_new, f_new, obj_new, g_new
        history[k] = obj
        done = converged

    # pad history beyond n_iters with the final objective
    history[k + 1:] = obj
    result = LbfgsResult(
        x=x, loss=obj, n_iters=k, history=history, converged=done,
        n_evals=counts["evals"], n_syncs=counts["syncs"],
    )
    if return_state:
        state = {
            "x": x, "f": f, "obj": obj, "g": g,
            "s_hist": s_hist, "y_hist": y_hist, "rho": rho,
            "k": np.asarray(k, np.int32), "n_upd": np.asarray(n_upd, np.int32),
            "done": np.asarray(done), "history": history,
        }
        return result, state
    return result
