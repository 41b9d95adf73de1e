"""FeatureHasher: the hashing trick over mixed-type columns.

Counterpart of ``sntc_tpu/feature/hashing.py`` (Spark's
``FeatureHasher``): any set of numeric, string or boolean columns into a
``numFeatures`` vector by murmur3 (seed 42):

  * numeric column: bucket = hash(colName), the value added as it is;
  * categorical (string, boolean, or listed in ``categoricalCols``):
    bucket = hash("colName=value"), adds 1.0;

colliding buckets accumulate.  Host numpy, with the port's own
``text._spark_bucket``.
"""

from __future__ import annotations

import numpy as np

from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.feature.text import _spark_bucket


class FeatureHasher(Transformer):
    inputCols = Param("columns to hash", default=())
    outputCol = Param("output vector column", default="features")
    #: Spark defaults to 2^18 for SPARSE vectors; these are dense, where
    #: 2^18 × rows is unusable past a few thousand rows, so the default
    #: is 4096 (the buckets still match Spark's at equal widths)
    numFeatures = Param("vector width", default=4096,
                        validator=validators.gt(0))
    categoricalCols = Param(
        "numeric columns to force categorical treatment", default=(),
    )

    def transform(self, frame: Frame) -> Frame:
        cols = list(self.getInputCols())
        if not cols:
            raise ValueError("inputCols must be set")
        nf = int(self.getNumFeatures())
        forced = set(self.getCategoricalCols())
        n = frame.num_rows
        if nf * max(n, 1) > 1 << 30:
            raise ValueError(
                f"dense output would hold {nf}×{n} floats; lower "
                "numFeatures (this frame has no sparse vectors)"
            )
        out = np.zeros((n, nf), np.float32)
        for c in cols:
            col = to_host(frame[c])
            numeric = (
                np.issubdtype(col.dtype, np.number)
                and not np.issubdtype(col.dtype, np.bool_)
                and c not in forced
            )
            if numeric:
                j = _spark_bucket(c, nf)
                out[:, j] += np.asarray(col, np.float32)
                continue
            cache: dict = {}
            idx = np.empty(n, np.int64)
            for r, v in enumerate(col):
                if isinstance(v, (bool, np.bool_)):
                    # Scala's Boolean.toString is lowercase: Python's
                    # str(True) would hash to another bucket
                    key = f"{c}={'true' if v else 'false'}"
                else:
                    key = f"{c}={v}"
                j = cache.get(key)
                if j is None:
                    j = cache[key] = _spark_bucket(key, nf)
                idx[r] = j
            # one whole 1.0 a row: exact in any order
            out[np.arange(n), idx] += 1.0
        return frame.with_column(self.getOutputCol(), out)
