"""tree_hist — the tree grower's level histogram, a CUDA kernel for Hopper.

Counterpart of ``sntc_tpu/ops/pallas_histogram.py``
(``level_histogram_pallas``, the Pallas kernel ``_hist_kernel``).
:func:`tree_hist` returns, for every tree ``t`` of a forest, the weighted
sufficient statistics of one level ``[T, F, n_nodes·n_bins, S]``::

    out[t, f, node[t, n]·n_bins + bin[f, n], :] += stats[t, n, :] · w[t, n]

over rows whose node id lies in ``[0, n_nodes)`` (``-1`` marks an
inactive row) and whose bin lies in ``[0, n_bins)``; ``w`` is 1 when no
weights are given.  The stats are ``[N, S]``, shared by every tree (the
random forest's one-hot classes), or ``[T, N, S]``, one row of stats per
tree (the one-vs-rest boosting fit: the JAX grower maps the Pallas
kernel over its per-class stats).  One call covers all ``T`` trees:

* on a CUDA tensor it launches ``csrc/tree_hist.cu``
  (:func:`tree_hist_cuda`) or raises;
* on a CPU tensor it computes :func:`tree_hist_reference`, the plain
  PyTorch version (``index_add_`` per tree and feature).

:func:`level_histogram` keeps the JAX function's layout: ``[F, N]`` bins,
``[N]`` (or ``[T, N]``) node ids and pre-weighted ``[N, S]`` stats.

With integer-valued weights and stats every cell is a small-integer f32
sum, exact in any order, so the kernel is bitwise equal to the plain
version; with fractional weights the two agree to f32 rounding (≤ 1e-5
relative), the kernel's last bits varying between runs.  The kernel has
two regimes, picked by shape inside its entry point (shared-memory
histograms, or one thread per row with reductions in L2);
:func:`tree_hist_plan` reports which one a shape takes.  Their design
and bounds are described in the source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sntc_tpu_torch.kernels import _build
from sntc_tpu_torch.obs.metrics import inc


def _check(binned_t, node_idx, stats, weights, n_nodes: int,
           n_bins: int) -> None:
    if binned_t.ndim != 2 or node_idx.ndim != 2 or stats.ndim not in (2, 3):
        raise ValueError(
            "expected binned_t [F, N], node_idx [T, N] and stats [N, S] "
            "or [T, N, S]"
        )
    F, N = binned_t.shape
    T = node_idx.shape[0]
    if stats.ndim == 3 and stats.shape[0] != T:
        raise ValueError(
            f"per-tree stats {tuple(stats.shape)} must have T = {T} rows "
            "of stats"
        )
    if node_idx.shape[1] != N or stats.shape[-2] != N:
        raise ValueError(
            f"row counts disagree: binned_t {tuple(binned_t.shape)}, "
            f"node_idx {tuple(node_idx.shape)}, stats {tuple(stats.shape)}"
        )
    if weights is not None and tuple(weights.shape) != (T, N):
        raise ValueError(
            f"weights {tuple(weights.shape)} must be [T, N] = {(T, N)}"
        )
    if binned_t.dtype != torch.int32 or node_idx.dtype != torch.int32:
        raise TypeError(
            f"binned_t and node_idx must be int32, got {binned_t.dtype}, "
            f"{node_idx.dtype}"
        )
    if stats.dtype != torch.float32 or (
        weights is not None and weights.dtype != torch.float32
    ):
        raise TypeError("stats and weights must be float32")
    if n_nodes < 1 or n_bins < 1:
        raise ValueError(f"n_nodes={n_nodes} and n_bins={n_bins} must be >= 1")
    tensors = [binned_t, node_idx, stats] + ([weights] if weights is not None else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {devices}")


def tree_hist_reference(
    binned_t: torch.Tensor,  # [F, N] int32
    node_idx: torch.Tensor,  # [T, N] int32, -1 = inactive
    stats: torch.Tensor,  # [N, S] or [T, N, S] f32
    weights: Optional[torch.Tensor] = None,  # [T, N] f32
    *,
    n_nodes: int,
    n_bins: int,
) -> torch.Tensor:
    """Plain version: per tree, the active rows' weighted stats
    (``stats · w``, the product the JAX grower forms; the tree's own
    stats where they are per tree) are added into each feature's flat
    cell ids with one ``index_add_``, in the stats' type (float64 stats
    give the exact sums a check compares float32 ones with)."""
    F, N = binned_t.shape
    T, S = node_idx.shape[0], stats.shape[-1]
    nb = n_nodes * n_bins
    out = torch.zeros((T, F, nb, S), dtype=stats.dtype, device=stats.device)
    for t in range(T):
        nd = node_idx[t]
        keep = (nd >= 0) & (nd < n_nodes)
        if weights is not None:
            keep &= weights[t] != 0
        rows = keep.nonzero().squeeze(1)
        data = (stats[t] if stats.ndim == 3 else stats)[rows]
        if weights is not None:
            data = data * weights[t, rows][:, None]
        base = nd[rows].long() * n_bins
        for f in range(F):
            b = binned_t[f, rows].long()
            ok = (b >= 0) & (b < n_bins)
            out[t, f].index_add_(0, (base + b)[ok], data[ok])
    return out


def tree_hist_cuda(
    binned_t: torch.Tensor,
    node_idx: torch.Tensor,
    stats: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    n_nodes: int,
    n_bins: int,
) -> torch.Tensor:
    """Launch the CUDA kernel (all inputs contiguous, on one CUDA
    device)."""
    _check(binned_t, node_idx, stats, weights, n_nodes, n_bins)
    named = [("binned_t", binned_t), ("node_idx", node_idx), ("stats", stats)]
    if weights is not None:
        named.append(("weights", weights))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} is not on a CUDA device: {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    F, N = binned_t.shape
    T, S = node_idx.shape[0], stats.shape[-1]
    out = torch.zeros((T, F, n_nodes * n_bins, S), dtype=torch.float32,
                      device=stats.device)
    if N == 0 or T == 0 or F == 0 or S == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(stats.device):
        err = lib.sntc_tree_hist_f32(
            binned_t.data_ptr(), node_idx.data_ptr(),
            None if weights is None else weights.data_ptr(),
            stats.data_ptr(), out.data_ptr(), N, F, T, n_nodes, n_bins, S,
            N * S if stats.ndim == 3 else 0,  # the stats' tree stride
            _build.stream_handle(stats.device),
        )
    _build.check_launch(lib, err, "tree_hist")
    _build.LAUNCHES["tree_hist"] += 1
    inc("sntc_kernel_dispatch_total", kernel="tree_hist", impl="cuda")
    return out


#: what :func:`tree_hist_plan` reports, in the C entry point's order
PLAN_FIELDS = ("regime", "feats_per_block", "trees_per_pass", "row_blocks",
               "grid_blocks")
REGIMES = ("shared", "rows")


def tree_hist_plan(n: int, n_feat: int, n_trees: int, n_nodes: int,
                   n_bins: int, s: int) -> dict:
    """How the CUDA kernel covers a launch of this shape on the current
    device — the plan its entry point computes, reported, not chosen."""
    lib = _build.library()
    out = (ctypes.c_int64 * len(PLAN_FIELDS))()
    err = lib.sntc_tree_hist_plan(n, n_feat, n_trees, n_nodes, n_bins, s, out)
    _build.check_launch(lib, err, "tree_hist plan")
    plan = dict(zip(PLAN_FIELDS, out))
    plan["regime"] = REGIMES[plan["regime"]]
    return plan


def tree_hist(binned_t, node_idx, stats, weights=None, *, n_nodes: int,
              n_bins: int) -> torch.Tensor:
    """Level histograms ``[T, F, n_nodes·n_bins, S]``: the CUDA kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    if stats.device.type == "cuda":
        return tree_hist_cuda(binned_t, node_idx, stats, weights,
                              n_nodes=n_nodes, n_bins=n_bins)
    if stats.device.type == "cpu":
        _check(binned_t, node_idx, stats, weights, n_nodes, n_bins)
        inc("sntc_kernel_dispatch_total", kernel="tree_hist", impl="plain")
        return tree_hist_reference(binned_t, node_idx, stats, weights,
                                   n_nodes=n_nodes, n_bins=n_bins)
    raise ValueError(f"unsupported device {stats.device}")


def level_histogram(binned_t, node_idx, weighted_stats, *, n_nodes: int,
                    n_bins: int) -> torch.Tensor:
    """``level_histogram_pallas``'s layout: ``[N]`` node ids give
    ``[F, n_nodes·n_bins, S]``, ``[T, N]`` node ids ``[T, F, ...]``
    (with ``[N, S]`` or per-tree ``[T, N, S]`` stats); the stats arrive
    pre-weighted."""
    if node_idx.ndim == 1:
        return tree_hist(binned_t, node_idx[None], weighted_stats,
                         n_nodes=n_nodes, n_bins=n_bins)[0]
    return tree_hist(binned_t, node_idx, weighted_stats, n_nodes=n_nodes,
                     n_bins=n_bins)
