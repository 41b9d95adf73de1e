"""forest_traversal — the RF/GBT/DT serving walk, a CUDA kernel for Hopper.

Counterpart of ``sntc_tpu/kernels/forest.py`` (``forest_leaf_stats_pallas``,
the Pallas kernel ``_forest_kernel``).  :func:`forest_leaf_stats` returns
the leaf stats ``[T, N, S]`` of every (tree, row) of a dense-heap forest:

* on a CUDA tensor it launches ``csrc/forest_traversal.cu``
  (:func:`forest_leaf_stats_cuda`) or raises;
* on a CPU tensor it computes :func:`forest_leaf_stats_reference`, the
  plain PyTorch version (the gathers of the JAX package's
  ``grower.forest_leaf_stats``).

The two are bitwise equal: the walk only compares and copies.  The
kernel's design and bound are described in its source.
"""

from __future__ import annotations

import torch

from sntc_tpu_torch.kernels import _build
from sntc_tpu_torch.obs.metrics import inc

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def forest_leaf_stats_reference(
    X: torch.Tensor,  # [N, F]
    feature: torch.Tensor,  # [T, M] int32 (-1 leaf, -2 absent)
    threshold: torch.Tensor,  # [T, M]
    leaf_stats: torch.Tensor,  # [T, M, S]
    *,
    max_depth: int,
) -> torch.Tensor:
    """Plain version: ``max_depth`` rounds of gathers over all (tree,
    row) pairs, then one gather of the leaf stats."""
    T, S = feature.shape[0], leaf_stats.shape[2]
    N = X.shape[0]
    node = torch.zeros((T, N), dtype=torch.long, device=X.device)
    Xt = X.t()  # [F, N]: xv[t, n] = X[n, f[t, n]]
    for _ in range(max_depth):
        f = feature.gather(1, node)
        is_internal = f >= 0
        fc = torch.where(is_internal, f, 0).long()
        xv = Xt.gather(0, fc)
        thr = threshold.gather(1, node)
        child = 2 * node + 1 + (xv >= thr).long()
        node = torch.where(is_internal, child, node)
    return leaf_stats.gather(1, node[:, :, None].expand(T, N, S))


def _check(X, feature, threshold, leaf_stats, max_depth: int) -> None:
    if X.ndim != 2 or feature.ndim != 2 or threshold.ndim != 2 \
            or leaf_stats.ndim != 3:
        raise ValueError(
            "expected X [N, F], feature [T, M], threshold [T, M], "
            "leaf_stats [T, M, S]"
        )
    T, M = feature.shape
    if threshold.shape != (T, M) or leaf_stats.shape[:2] != (T, M):
        raise ValueError(
            f"forest shapes disagree: feature {tuple(feature.shape)}, "
            f"threshold {tuple(threshold.shape)}, "
            f"leaf_stats {tuple(leaf_stats.shape)}"
        )
    if M < 2 ** (max_depth + 1) - 1:
        raise ValueError(
            f"a depth-{max_depth} walk needs {2 ** (max_depth + 1) - 1} "
            f"heap slots per tree, the forest has {M}"
        )
    if feature.dtype != torch.int32:
        raise TypeError(f"feature must be int32, got {feature.dtype}")
    if X.dtype not in _DTYPES or threshold.dtype != X.dtype \
            or leaf_stats.dtype != X.dtype:
        raise TypeError(
            "X, threshold and leaf_stats must share one dtype (float32 or "
            f"float64), got {X.dtype}, {threshold.dtype}, {leaf_stats.dtype}"
        )
    devices = {t.device for t in (X, feature, threshold, leaf_stats)}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {devices}")


def forest_leaf_stats_cuda(
    X: torch.Tensor,
    feature: torch.Tensor,
    threshold: torch.Tensor,
    leaf_stats: torch.Tensor,
    *,
    max_depth: int,
) -> torch.Tensor:
    """Launch the CUDA kernel (all inputs contiguous, on one CUDA device;
    every internal node's feature index below ``F``)."""
    _check(X, feature, threshold, leaf_stats, max_depth)
    for name, t in (("X", X), ("feature", feature), ("threshold", threshold),
                    ("leaf_stats", leaf_stats)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is not on a CUDA device: {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    N, F = X.shape
    T, M = feature.shape
    S = leaf_stats.shape[2]
    out = torch.empty((T, N, S), dtype=X.dtype, device=X.device)
    if N == 0 or T == 0:
        return out
    lib = _build.library()
    fn = getattr(lib, f"sntc_forest_leaf_stats_{_DTYPES[X.dtype]}")
    with torch.cuda.device(X.device):
        err = fn(
            X.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
            leaf_stats.data_ptr(), out.data_ptr(), N, F, T, M, S,
            int(max_depth), _build.stream_handle(X.device),
        )
    _build.check_launch(lib, err, "forest_traversal")
    _build.LAUNCHES["forest_traversal"] += 1
    inc("sntc_kernel_dispatch_total", kernel="forest_traversal", impl="cuda")
    return out


def forest_leaf_stats(X, feature, threshold, leaf_stats, *, max_depth: int):
    """Leaf stats ``[T, N, S]``: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if X.device.type == "cuda":
        return forest_leaf_stats_cuda(
            X, feature, threshold, leaf_stats, max_depth=max_depth
        )
    if X.device.type == "cpu":
        _check(X, feature, threshold, leaf_stats, max_depth)
        inc("sntc_kernel_dispatch_total", kernel="forest_traversal",
            impl="plain")
        return forest_leaf_stats_reference(
            X, feature, threshold, leaf_stats, max_depth=max_depth
        )
    raise ValueError(f"unsupported device {X.device}")
