"""Dense-heap forests — the serving half of ``sntc_tpu/models/tree/grower.py``.

A tree is a DENSE heap of ``2^(max_depth+1)-1`` node slots:
``feature[t, h] >= 0`` marks an internal node splitting on that feature
at ``threshold[t, h]`` (a row goes right when ``x >= threshold``), ``-1``
a leaf holding ``leaf_stats[t, h]``, ``-2`` a slot never created.  The
serving walk is ``kernels/forest.py`` (the CUDA kernel and its plain
version ``forest_leaf_stats_reference``); the level-wise grower comes
with the fit-side slice and its ``tree_hist`` kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Forest(NamedTuple):
    """Dense-heap forest, host arrays. H = 2^(max_depth+1) - 1 slots per
    tree; ``gain``/``count`` feed feature importances and ride along
    through save/load."""

    feature: np.ndarray  # [T, H] int32
    threshold: np.ndarray  # [T, H] f32
    leaf_stats: np.ndarray  # [T, H, S] f32
    max_depth: int
    gain: np.ndarray = None  # [T, H] f32
    count: np.ndarray = None  # [T, H] f32


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


class ForestDeviceMixin:
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

    def _device_forest(self) -> tuple:
        return self._dev_forest
