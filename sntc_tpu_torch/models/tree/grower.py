"""Dense-heap forests and the level-wise binned grower.

Counterpart of ``sntc_tpu/models/tree/grower.py`` (Spark's
``RandomForest.run`` with ``DTStatsAggregator``).  A tree is a DENSE heap
of ``2^(max_depth+1)-1`` node slots: ``feature[t, h] >= 0`` marks an
internal node splitting on that feature at ``threshold[t, h]`` (a row
goes right when ``x >= threshold``), ``-1`` a leaf holding
``leaf_stats[t, h]``, ``-2`` a slot never created.  The serving walk is
``kernels/forest.py``.

:func:`grow_forest` grows all trees level by level on the binned
features' device: per level, the ``tree_hist`` kernel (``kernels/
histogram.py``) builds every tree's ``[nodes, F, B, S]`` histogram in
one launch per node group, the split search is PyTorch on the same
device, and rows route to their children by bin id.  The depth loop is a
Python loop; decisions stay on the device and the heaps come back to the
host once.

Random draws come from the host: the bagging weights ``[T, N]`` and, per
level, the feature-subset uniforms ``[T, nodes, F]`` are drawn with
numpy from the estimator's seed, so a fit is the same on the card and on
the CPU.  They are not the JAX package's ``jax.random`` draws; the two
packages grow the same trees only without random draws (no bootstrap,
``subsamplingRate`` 1, ``featureSubsetStrategy="all"``).

Split gains are computed in float32 with sums over the stats axis taken
in one fixed order on every device, so the card and the CPU pick the
same splits from the same histograms.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from sntc_tpu_torch.kernels.histogram import tree_hist
from sntc_tpu_torch.models.base import DeviceHeadMixin

# the level working set (histogram + cumsum + left/right + gains, ~5x the
# raw histogram) per node group; deeper levels take several passes
NODE_GROUP_BUDGET_BYTES = 2048 * 1024 * 1024
# a level's full histogram is kept for its children's sibling
# subtraction only up to this size
SIBLING_BUDGET_BYTES = 1024 * 1024 * 1024


class Forest(NamedTuple):
    """Dense-heap forest, host arrays. H = 2^(max_depth+1) - 1 slots per
    tree; ``gain``/``count`` are set on internal nodes (0 elsewhere) and
    feed the feature importances."""

    feature: np.ndarray  # [T, H] int32
    threshold: np.ndarray  # [T, H] f32
    leaf_stats: np.ndarray  # [T, H, S] f32
    max_depth: int
    gain: np.ndarray = None  # [T, H] f32
    count: np.ndarray = None  # [T, H] f32

    def feature_importances(
        self, n_features: int, per_tree_normalization: bool = True
    ) -> np.ndarray:
        """Gain×count importances with Spark's ``featureImportances``
        semantics: each tree's contributions normalized to sum 1 first
        for forests, then the total normalized."""
        if self.gain is None or self.count is None:
            raise ValueError(
                "featureImportances unavailable: this model was saved "
                "without per-node split statistics (gain/count); re-fit "
                "to compute importances"
            )
        total = np.zeros(n_features, np.float64)
        for t in range(self.feature.shape[0]):
            imp = np.zeros(n_features, np.float64)
            internal = self.feature[t] >= 0
            np.add.at(
                imp,
                self.feature[t][internal],
                (self.gain[t] * self.count[t])[internal],
            )
            if per_tree_normalization:
                s = imp.sum()
                if s > 0:
                    total += imp / s
            else:
                total += imp
        s = total.sum()
        return (total / s if s > 0 else total).astype(np.float64)


def validate_forest(forest: Forest, n_features: int = 0) -> None:
    """Reject a forest whose walk could leave its arrays: the heap must
    hold ``max_depth`` levels, and every internal node's feature index
    must be below the feature width (the CUDA walk does not bound-check
    per row)."""
    T, H = forest.feature.shape
    if H < 2 ** (forest.max_depth + 1) - 1:
        raise ValueError(
            f"a depth-{forest.max_depth} forest needs "
            f"{2 ** (forest.max_depth + 1) - 1} heap slots, got {H}"
        )
    if forest.threshold.shape != (T, H) or forest.leaf_stats.shape[:2] != (T, H):
        raise ValueError("forest arrays disagree in shape")
    internal = forest.feature[forest.feature >= 0]
    if n_features and internal.size and int(internal.max()) >= n_features:
        raise ValueError(
            f"forest splits on feature {int(internal.max())} of a "
            f"{n_features}-wide input"
        )


class ForestPersistenceMixin:
    """Save/load payload of a model that is a dense-heap forest plus
    ``_n_features`` — the JAX package's directory layout."""

    def _extra_meta(self) -> dict:
        return {}

    def _save_extra(self):
        meta = {
            "max_depth": self.forest.max_depth,
            "n_features": self._n_features,
        }
        meta.update(self._extra_meta())
        return meta, {
            "feature": self.forest.feature,
            "threshold": self.forest.threshold,
            "leaf_stats": self.forest.leaf_stats,
            "gain": self.forest.gain,
            "count": self.forest.count,
        }

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        forest = Forest(
            arrays["feature"], arrays["threshold"], arrays["leaf_stats"],
            int(extra["max_depth"]),
            arrays.get("gain"), arrays.get("count"),
        )
        m = cls._from_forest(forest, extra, device)
        m.setParams(**params)
        return m

    @property
    def featureImportances(self) -> np.ndarray:
        n = self._n_features or int(self.forest.feature.max()) + 1
        return self.forest.feature_importances(n)


class ForestDeviceMixin(DeviceHeadMixin):
    """The forest tensors on the model's device, uploaded once at
    construction — not once per serving micro-batch — in float32, the
    type the serving features are cast to."""

    def _upload_forest(self, device) -> None:
        f = self.forest
        self.device = torch.device(device)
        self._dev_forest = (
            torch.from_numpy(np.ascontiguousarray(f.feature, np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(f.threshold, np.float32))
            .to(self.device),
            torch.from_numpy(np.ascontiguousarray(f.leaf_stats, np.float32))
            .to(self.device),
        )
        internal = f.feature[f.feature >= 0]
        # the walk reads X[row, f]: a batch must be wider than this
        self._max_feature = int(internal.max()) if internal.size else -1
        self._thr_cache = None

    def _device_forest(self) -> tuple:
        return self._dev_forest

    def _features_on_device(self, X) -> torch.Tensor:
        """``X`` (numpy or a tensor) as a contiguous float32 tensor on
        the model's device, refused when it is too narrow for the
        forest."""
        X = super()._features_on_device(X)
        if (self._n_features and X.shape[1] != self._n_features) or \
                X.shape[1] <= self._max_feature:
            raise ValueError(
                f"a batch of {X.shape[1]} features does not fit a model of "
                f"{self._n_features} features splitting on index "
                f"{self._max_feature}"
            )
        return X.contiguous()


# -- growing -----------------------------------------------------------------


def make_bagging_weights(rng: np.random.Generator, bootstrap: bool,
                         rate: float, T: int, n: int) -> np.ndarray:
    """Per-tree row weights ``[T, n]`` float32 on the host: Poisson(rate)
    with replacement, Bernoulli(rate) masks without (the JAX package's
    documented deviation from Spark's exact sampling)."""
    if bootstrap:
        return rng.poisson(rate, size=(T, n)).astype(np.float32)
    if rate < 1.0:
        return (rng.random((T, n)) < rate).astype(np.float32)
    return np.ones((T, n), np.float32)


def resolve_feature_subset_k(strategy, n_features: int, n_trees: int,
                             is_classification: bool) -> int:
    """Spark's ``featureSubsetStrategy`` semantics."""
    if isinstance(strategy, (int, np.integer)):
        k = int(strategy)
    elif strategy == "auto":
        if n_trees == 1:
            k = n_features
        elif is_classification:
            k = int(math.ceil(math.sqrt(n_features)))
        else:
            k = max(1, n_features // 3)
    elif strategy == "all":
        k = n_features
    elif strategy == "sqrt":
        k = int(math.ceil(math.sqrt(n_features)))
    elif strategy == "log2":
        k = max(1, int(math.floor(math.log2(n_features))))
    elif strategy == "onethird":
        k = max(1, n_features // 3)
    else:
        try:
            frac = float(strategy)
        except (TypeError, ValueError):
            raise ValueError(f"unknown featureSubsetStrategy {strategy!r}")
        if not 0 < frac <= 1:
            raise ValueError(f"featureSubsetStrategy fraction {frac} not in (0,1]")
        k = max(1, int(math.ceil(frac * n_features)))
    return min(max(k, 1), n_features)


def node_group_size(T: int, F: int, n_bins: int, S: int) -> int:
    """Nodes per histogram pass: the largest power of two whose level
    working set (~5x the ``[T, nodes, F, B, S]`` f32 histogram) stays
    under :data:`NODE_GROUP_BUDGET_BYTES` (Spark's ``maxMemoryInMB``
    bounds its node groups the same way)."""
    per_node = 5.0 * T * F * n_bins * S * 4
    raw = max(1, int(NODE_GROUP_BUDGET_BYTES / per_node))
    return 1 << (raw.bit_length() - 1)  # pow2: levels split evenly


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, element by element in index order: the
    same float32 rounding on every device (a library reduction picks
    its order per device)."""
    out = x[..., 0]
    for s in range(1, x.shape[-1]):
        out = out + x[..., s]
    return out


def _sum_sq_last(x: torch.Tensor) -> torch.Tensor:
    out = x[..., 0] * x[..., 0]
    for s in range(1, x.shape[-1]):
        out = out + x[..., s] * x[..., s]
    return out


def _weighted_impurity(stats: torch.Tensor, impurity: str) -> torch.Tensor:
    """``weight * impurity`` for a stats vector (last axis S).

    gini:    w - Σ s²/w          entropy: Σ -s·log(s/w)
    variance: Σwy² - (Σwy)²/w   (stats = [w, wy, wy²])
    """
    if impurity in ("gini", "entropy"):
        w = _sum_last(stats)
        safe_w = w.clamp_min(1e-12)
        if impurity == "gini":
            return w - _sum_sq_last(stats) / safe_w
        p = stats / safe_w[..., None]
        terms = torch.where(
            stats > 0, stats * torch.log(p.clamp_min(1e-12)),
            torch.zeros((), dtype=stats.dtype, device=stats.device),
        )
        return -_sum_last(terms)
    w = stats[..., 0]
    safe_w = w.clamp_min(1e-12)
    return stats[..., 2] - stats[..., 1] * stats[..., 1] / safe_w


def _stat_count(stats: torch.Tensor, impurity: str) -> torch.Tensor:
    if impurity == "variance":
        return stats[..., 0]
    return _sum_last(stats)


def _eval_from_hist(hist, fmask, min_instances: float, *, impurity: str):
    """Best split of every node of a group histogram ``[T, g, F, B, S]``:
    the gain of each (feature, bin) threshold from the bin cumsums, the
    argmax (first maximum), and the chosen split's child stats."""
    T, g, F, n_bins, S = hist.shape
    cum = torch.cumsum(hist, dim=3)  # left stats for a split at bin b
    parent = cum[:, :, 0, -1, :]  # [T, g, S]
    left = cum[:, :, :, :-1, :]  # [T, g, F, B-1, S]
    right = parent[:, :, None, None, :] - left

    imp_parent = _weighted_impurity(parent, impurity)  # [T, g]
    gain_w = (
        imp_parent[:, :, None, None]
        - _weighted_impurity(left, impurity)
        - _weighted_impurity(right, impurity)
    )
    parent_cnt = _stat_count(parent, impurity)
    gain = gain_w / parent_cnt.clamp_min(1e-12)[:, :, None, None]

    valid = (
        (_stat_count(left, impurity) >= min_instances)
        & (_stat_count(right, impurity) >= min_instances)
    )
    if fmask is not None:  # per-(tree, node) feature subset of the level
        valid = valid & fmask[:, :, :, None]
    gain = torch.where(valid, gain, torch.full((), -math.inf, device=gain.device))

    flat = gain.reshape(T, g, F * (n_bins - 1))
    best = torch.argmax(flat, dim=2)  # [T, g] int64, first maximum
    best_gain = flat.gather(2, best[..., None])[..., 0]
    best_feat = best // (n_bins - 1)
    best_bin = best % (n_bins - 1)

    take_f = left.gather(
        2, best_feat[:, :, None, None, None].expand(T, g, 1, n_bins - 1, S)
    )[:, :, 0]  # [T, g, B-1, S]
    bl = take_f.gather(2, best_bin[:, :, None, None].expand(T, g, 1, S))[:, :, 0]
    return {
        "best_feat": best_feat,
        "best_bin": best_bin,
        "best_gain": best_gain,
        "parent_stats": parent,
        "parent_count": parent_cnt,
        "left_stats": bl,
        "right_stats": parent - bl,
    }


def _group_hist(binned_t, row_stats, w_trees, ids, *, g_eff: int,
                n_bins: int) -> torch.Tensor:
    """Histogram ``[T, g_eff, F, B, S]`` over group-local node ids
    ``[T, N]`` (-1 = not in the group): one ``tree_hist`` call for all
    trees, shared ``[N, S]`` or per-tree ``[T, N, S]`` row stats, the
    bagging weights applied inside."""
    F = binned_t.shape[0]
    T, S = ids.shape[0], row_stats.shape[-1]
    h = tree_hist(binned_t, ids, row_stats, w_trees, n_nodes=g_eff,
                  n_bins=n_bins)  # [T, F, g_eff * B, S]
    return h.view(T, F, g_eff, n_bins, S).permute(0, 2, 1, 3, 4)


def _eval_node_group(binned_t, row_stats, w_trees, node_idx, fmask,
                     min_instances, parent_hist, *, lo: int, g: int,
                     n_bins: int, impurity: str, keep_hist: bool):
    """Histogram + best-split evaluation for the ``g`` nodes of a level
    starting at level-local id ``lo``; rows of other nodes count as
    inactive.

    With ``parent_hist`` (sibling subtraction, the LightGBM/XGBoost
    trick): only the EVEN (left) children are histogrammed from rows;
    each odd sibling is ``parent − left``, since a split parent's rows
    partition into its two children.  Exact on integer-valued stats.
    Children of parents that did not split derive garbage (parent − 0),
    masked before any heap write; no row routes there."""
    if parent_hist is not None and g >= 2:
        ids_even = torch.where(
            (node_idx >= lo) & (node_idx < lo + g) & ((node_idx & 1) == 0),
            (node_idx - lo) >> 1, -1,
        ).to(torch.int32)
        h_even = _group_hist(binned_t, row_stats, w_trees, ids_even,
                             g_eff=g // 2, n_bins=n_bins)
        h_odd = parent_hist[:, lo // 2: lo // 2 + g // 2] - h_even
        if impurity in ("gini", "entropy"):
            # a true-zero sibling cell must not surface as a tiny
            # negative count; variance stats are signed and not clamped
            h_odd = h_odd.clamp_min(0.0)
        T, _, F, _, S = h_even.shape
        hist = torch.stack([h_even, h_odd], dim=2).reshape(T, g, F, n_bins, S)
    else:
        ids = torch.where(
            (node_idx >= lo) & (node_idx < lo + g), node_idx - lo, -1
        ).to(torch.int32)
        hist = _group_hist(binned_t, row_stats, w_trees, ids, g_eff=g,
                           n_bins=n_bins)
    out = _eval_from_hist(hist, fmask, min_instances, impurity=impurity)
    if keep_hist:
        out["hist"] = hist
    return out


def _level(binned_t, row_stats, w_trees, node_idx, fmask, min_instances,
           min_info_gain, parent_hist, *, n_nodes: int, n_bins: int,
           impurity: str, group: int, route: bool, keep_hist: bool):
    """One level: histogram + split evaluation in node groups of at most
    ``group`` nodes, then (unless ``route`` is off, at the last level)
    every row routed to its child by bin id."""
    outs = []
    for lo in range(0, n_nodes, group):
        g = min(group, n_nodes)
        outs.append(_eval_node_group(
            binned_t, row_stats, w_trees, node_idx,
            None if fmask is None else fmask[:, lo:lo + g],
            min_instances, parent_hist, lo=lo, g=g, n_bins=n_bins,
            impurity=impurity, keep_hist=keep_hist,
        ))
    out = (outs[0] if len(outs) == 1
           else {k: torch.cat([o[k] for o in outs], dim=1) for k in outs[0]})

    has_rows = out["parent_count"] > 0
    best_gain = out["best_gain"]
    # Spark treats minInfoGain=0 as "any strictly positive gain"
    do_split = (has_rows & torch.isfinite(best_gain)
                & (best_gain > min_info_gain) & (best_gain > 0))
    out["do_split"] = do_split

    if route:
        idx = node_idx.clamp_min(0).long()  # [T, N]
        splits = do_split.gather(1, idx)
        feats = out["best_feat"].gather(1, idx)
        bins_thr = out["best_bin"].gather(1, idx)
        row_bins = binned_t.gather(0, feats)  # binned_t[feats[t, n], n]
        child = 2 * idx + (row_bins > bins_thr).long()
        out["new_node_idx"] = torch.where(
            (node_idx >= 0) & splits, child, -1
        ).to(torch.int32)
    return out


def grow_forest(
    binned_t: torch.Tensor,  # [F, N] int32 bin ids
    row_stats: torch.Tensor,  # [N, S] shared or [T, N, S] per-tree f32
    w_trees: torch.Tensor,  # [T, N] f32 bagging weights
    edges: np.ndarray,  # [F, B-1] host bin thresholds
    *,
    n_bins: int,
    max_depth: int,
    min_instances_per_node: float,
    min_info_gain: float,
    subset_k: int,
    impurity: str,
    rng: Optional[np.random.Generator] = None,
    sibling: Optional[bool] = None,
) -> Forest:
    """Grow ``T`` trees level-synchronously on ``binned_t``'s device;
    returns host-side dense heaps.

    ``row_stats`` is shared by every tree (``[N, S]``: one-hot class ×
    row weight) or one row of stats per tree (``[T, N, S]``: the
    one-vs-rest boosting fit, where tree ``t`` is class ``t``'s binary
    problem over the same binned features).

    ``rng`` draws the per-level feature-subset uniforms (needed when
    ``subset_k < F``).  ``sibling`` turns sibling-histogram subtraction
    on or off; by default it is on where the histograms run on the CUDA
    kernel, whose cost grows with the node-axis width it halves, and off
    on the CPU, where the plain version's cost does not depend on it."""
    F, n = binned_t.shape
    T, S = w_trees.shape[0], row_stats.shape[-1]
    dev = binned_t.device
    H = (1 << (max_depth + 1)) - 1
    if max_depth == 0:
        feature = np.full((T, H), -2, np.int32)
        feature[:, 0] = -1
        leaf_stats = np.zeros((T, H, S), np.float32)
        root = (torch.einsum("tn,tns->ts", w_trees, row_stats)
                if row_stats.ndim == 3 else w_trees @ row_stats)
        leaf_stats[:, 0] = root.cpu().numpy()
        zeros = np.zeros((T, H), np.float32)
        return Forest(feature, zeros.copy(), leaf_stats, 0, zeros.copy(),
                      zeros.copy())
    if subset_k < F and rng is None:
        raise ValueError("a feature subset needs an rng for its draws")

    group = node_group_size(T, F, n_bins, S)
    sib_on = group >= 2 and (dev.type == "cuda" if sibling is None else sibling)
    hist_bytes_per_node = T * F * n_bins * S * 4
    keep_hists = [
        sib_on and d < max_depth - 1
        and (1 << d) * hist_bytes_per_node <= SIBLING_BUDGET_BYTES
        for d in range(max_depth)
    ]

    edges_dev = torch.from_numpy(np.ascontiguousarray(edges, np.float32)).to(dev)
    feature = torch.full((T, H), -2, dtype=torch.int32, device=dev)
    threshold = torch.zeros((T, H), dtype=torch.float32, device=dev)
    leaf_stats = torch.zeros((T, H, S), dtype=torch.float32, device=dev)
    gain_a = torch.zeros((T, H), dtype=torch.float32, device=dev)
    count_a = torch.zeros((T, H), dtype=torch.float32, device=dev)
    node_idx = torch.zeros((T, n), dtype=torch.int32, device=dev)
    exists_lvl = torch.ones((T, 1), dtype=torch.bool, device=dev)  # the root

    # per-level feature subsets, drawn for a whole level at once (so they
    # do not depend on how its nodes are grouped) and uploaded before
    # the loop: an upload from pageable memory inside it would wait for
    # the level's kernels
    fmasks = [None] * max_depth
    if subset_k < F:
        for depth in range(max_depth):
            r = rng.random((T, 1 << depth, F), dtype=np.float32)
            kth = np.partition(r, subset_k - 1, axis=-1)[..., subset_k - 1]
            fmasks[depth] = r <= kth[..., None]
        fmasks = [torch.from_numpy(m).to(dev) for m in fmasks]

    prev_hist = None
    for depth in range(max_depth):
        n_nodes = 1 << depth
        off = n_nodes - 1
        fmask = fmasks[depth]
        out = _level(
            binned_t, row_stats, w_trees, node_idx, fmask,
            min_instances_per_node, min_info_gain, prev_hist,
            n_nodes=n_nodes, n_bins=n_bins, impurity=impurity, group=group,
            route=depth < max_depth - 1, keep_hist=keep_hists[depth],
        )
        prev_hist = out.get("hist")
        split_mask = out["do_split"] & exists_lvl
        leaf_mask = exists_lvl & ~split_mask

        lvl = slice(off, off + n_nodes)
        bf, bb = out["best_feat"], out["best_bin"]
        feature[:, lvl] = torch.where(
            split_mask, bf, torch.where(exists_lvl, -1, -2)
        ).to(torch.int32)
        threshold[:, lvl] = torch.where(split_mask, edges_dev[bf, bb], 0.0)
        leaf_stats[:, lvl, :] = torch.where(
            leaf_mask[..., None], out["parent_stats"], 0.0
        )
        gain_a[:, lvl] = torch.where(split_mask, out["best_gain"], 0.0)
        count_a[:, lvl] = torch.where(split_mask, out["parent_count"], 0.0)

        # children are written as leaves with the chosen split's child
        # stats; the next level overwrites its whole slice, re-deciding
        # which of them split further
        child_exists = split_mask[:, :, None].expand(
            T, n_nodes, 2).reshape(T, 2 * n_nodes)
        child_stats = torch.stack(
            [out["left_stats"], out["right_stats"]], dim=2
        ).reshape(T, 2 * n_nodes, S)
        lvl2 = slice(off + n_nodes, off + 3 * n_nodes)
        feature[:, lvl2] = torch.where(child_exists, -1, -2).to(torch.int32)
        leaf_stats[:, lvl2, :] = torch.where(
            child_exists[..., None], child_stats, 0.0
        )
        exists_lvl = child_exists
        if depth < max_depth - 1:
            node_idx = out["new_node_idx"]

    return Forest(
        feature.cpu().numpy(), threshold.cpu().numpy(),
        leaf_stats.cpu().numpy(), max_depth, gain_a.cpu().numpy(),
        count_a.cpu().numpy(),
    )

