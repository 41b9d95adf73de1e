"""Frame — the columnar dataset (the DataFrame analog).

Counterpart of ``sntc_tpu/core/frame.py``: an immutable, ordered
collection of named columns.  Scalar columns are ``(N,)`` arrays; vector
columns (the ``VectorAssembler`` output) are ``(N, D)`` arrays.  pyarrow
is the interchange format at the IO boundary.

A column is either a numpy array (host data, as parsed) or a
``torch.Tensor`` held as it is: a column that already lives on the card
(the bucket-padded feature block, the assembled features) flows to the
next stage without a round trip through the host.  Anything that needs
host values (Arrow export, concatenation of mixed frames) materializes
tensors with :func:`to_host`.  A row gather of such a frame uploads its indices
once per device, recorded in the transfer ledger.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np
import pyarrow as pa
import torch

from sntc_tpu_torch.utils.profiling import upload

ColumnLike = Union[np.ndarray, torch.Tensor, Sequence]


def object_column(values: Sequence) -> np.ndarray:
    """1-D object column of ragged values (token lists, itemsets).

    ``np.array(list_of_lists, dtype=object)`` builds a 2-D array when
    every inner list shares a length; the explicit fill keeps the column
    rank-1 whatever the lengths."""
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        col[i] = v
    return col


def to_host(a) -> np.ndarray:
    """A column's values as a numpy array (tensors are copied off the
    device; numpy columns pass through)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _coerce_column(name: str, value: ColumnLike):
    """Coerce one column to an array and validate its rank; tensors are
    held as they are."""
    if isinstance(value, (np.ndarray, torch.Tensor)):
        arr = value
    else:
        arr = np.asarray(value)
    if arr.ndim not in (1, 2):
        raise ValueError(
            f"column {name!r} must be 1-D or 2-D, got shape {tuple(arr.shape)}"
        )
    return arr


class Frame:
    """Immutable ordered mapping of column name -> array.

    All columns share the same leading dimension (row count). 1-D columns are
    scalars, 2-D columns are fixed-width vectors.
    """

    __slots__ = ("_columns", "_num_rows")

    def __init__(self, columns: Mapping[str, ColumnLike]):
        cols: Dict[str, object] = {}
        num_rows: Optional[int] = None
        for name, value in columns.items():
            arr = _coerce_column(name, value)
            if num_rows is None:
                num_rows = arr.shape[0]
            elif arr.shape[0] != num_rows:
                raise ValueError(
                    f"column {name!r} has {arr.shape[0]} rows, expected {num_rows}"
                )
            cols[name] = arr
        self._columns = cols
        self._num_rows = 0 if num_rows is None else int(num_rows)

    @classmethod
    def _wrap(cls, cols: Dict[str, object], num_rows: int) -> "Frame":
        """Trusted constructor for derived frames whose columns were already
        validated (select/drop/slice/... reuse or uniformly re-index them)."""
        f = object.__new__(cls)
        f._columns = cols
        f._num_rows = num_rows
        return f

    # -- basic accessors -------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __getitem__(self, name: str):
        try:
            return self._columns[name]
        except KeyError:
            raise KeyError(
                f"no column {name!r}; available: {list(self._columns)}"
            ) from None

    # -- transformations (each returns a new Frame) ----------------------------

    def with_column(self, name: str, value: ColumnLike) -> "Frame":
        arr = _coerce_column(name, value)
        # a frame with rows (or columns) pins the row count; only a truly
        # empty frame (no columns, 0 rows) accepts any length
        if (self._columns or self._num_rows) and arr.shape[0] != self._num_rows:
            raise ValueError(
                f"column {name!r} has {arr.shape[0]} rows, expected "
                f"{self._num_rows}"
            )
        cols = dict(self._columns)
        cols[name] = arr
        return Frame._wrap(cols, int(arr.shape[0]))

    def select(self, names: Iterable[str]) -> "Frame":
        return Frame._wrap({n: self[n] for n in names}, self._num_rows)

    def drop(self, *names: str) -> "Frame":
        return Frame._wrap(
            {n: a for n, a in self._columns.items() if n not in names},
            self._num_rows,
        )

    def filter(self, mask: np.ndarray) -> "Frame":
        mask = np.asarray(mask)
        if mask.dtype != np.bool_ or mask.shape != (self._num_rows,):
            raise ValueError("filter mask must be a boolean (N,) array")
        n = int(np.count_nonzero(mask))
        if mask[:n].all():
            # a leading run of kept rows (bucket padding's shape): views,
            # no copy and no device gather
            return self.slice(0, n)
        return self.take(np.flatnonzero(mask))

    def take(self, indices: np.ndarray) -> "Frame":
        indices = np.asarray(indices)
        if indices.dtype == np.bool_:  # boolean masks select, not index
            return self.filter(indices)
        if indices.ndim != 1:
            raise ValueError(
                f"take() indices must be 1-D, got shape {indices.shape}"
            )
        indices = indices.astype(np.int64, copy=False)
        on_device: dict = {}  # the indices uploaded once per device

        def rows(a):
            if not isinstance(a, torch.Tensor):
                return a[indices]
            idx = on_device.get(a.device)
            if idx is None:
                idx = on_device[a.device] = upload(indices, a.device)
            return a.index_select(0, idx)

        return Frame._wrap(
            {n: rows(a) for n, a in self._columns.items()},
            int(indices.shape[0]),
        )

    def fill_invalid_rows(self, valid: np.ndarray) -> "Frame":
        """Replace every row where ``valid`` is False with a copy of the
        nearest preceding valid row (the first valid row for a leading
        invalid run; zeros, or empty strings, when no row is valid).

        Row admission excises poison rows this way without changing the
        frame's shape: the donor values only keep the device compute in
        its domain and are dropped at finalize, like bucket padding."""
        valid = np.asarray(valid)
        if valid.dtype != np.bool_ or valid.shape != (self._num_rows,):
            raise ValueError(
                "fill_invalid_rows mask must be a boolean (N,) array"
            )
        if valid.all():
            return self  # immutable: safe to share
        n = self._num_rows
        if valid.any():
            # donor[i]: the nearest valid row at or before i
            idx = np.where(valid, np.arange(n), -1)
            donor = np.maximum.accumulate(idx)
            donor[donor < 0] = int(np.flatnonzero(valid)[0])
            return self.take(donor)
        cols: Dict[str, object] = {}
        for name, a in self._columns.items():
            a = to_host(a)
            if a.dtype.kind in "OUS":
                cols[name] = np.full(a.shape, "", dtype=a.dtype)
            else:
                cols[name] = np.zeros(a.shape, dtype=a.dtype)
        return Frame._wrap(cols, n)

    def slice(self, start: int, stop: Optional[int] = None) -> "Frame":
        n = len(range(*slice(start, stop).indices(self._num_rows)))
        return Frame._wrap(
            {k: a[start:stop] for k, a in self._columns.items()}, n
        )

    def random_split(
        self, weights: Sequence[float], seed: int = 0
    ) -> List["Frame"]:
        """Spark ``DataFrame.randomSplit`` analog: a shuffled proportional
        split, the same numpy permutation as the JAX package's, so a seed
        splits the same rows in both."""
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self._num_rows)
        edges = np.floor(np.cumsum(w) * self._num_rows).astype(np.int64)
        edges[-1] = self._num_rows  # cumsum can underflow 1.0; never drop rows
        out, start = [], 0
        for stop in edges:
            out.append(self.take(perm[start:stop]))
            start = stop
        return out

    @classmethod
    def concat_all(cls, frames: Sequence["Frame"]) -> "Frame":
        """Concatenate frames with one allocation per column.  Columns
        are joined on the host: frames of one batch may hold the same
        column on the card in one chunk and on the host in another."""
        if not frames:
            raise ValueError("concat_all requires at least one frame")
        first = frames[0]
        if len(frames) == 1:
            return first  # immutable — safe to share
        for f in frames[1:]:
            if f.columns != first.columns:
                raise ValueError("concat requires identical column sets/order")
        return cls(
            {
                n: np.concatenate([to_host(f._columns[n]) for f in frames])
                for n in first.columns
            }
        )

    # -- Arrow interchange -----------------------------------------------------

    @classmethod
    def from_arrow(cls, table: Union[pa.Table, pa.RecordBatch]) -> "Frame":
        if isinstance(table, pa.RecordBatch):
            table = pa.Table.from_batches([table])
        if len(set(table.column_names)) != len(table.column_names):
            raise ValueError(
                "duplicate column names in Arrow table (deduplicate first, "
                f"e.g. at the CSV ingest layer): {table.column_names}"
            )
        cols: Dict[str, np.ndarray] = {}
        for name, col in zip(table.column_names, table.columns):
            if isinstance(col, pa.ChunkedArray):
                col = col.combine_chunks()
            if pa.types.is_fixed_size_list(col.type):
                width = col.type.list_size
                values = col.values.to_numpy(zero_copy_only=False)
                cols[name] = values.reshape(-1, width)
            else:
                cols[name] = col.to_numpy(zero_copy_only=False)
        return cls(cols)

    def to_arrow(self) -> pa.Table:
        arrays, names = [], []
        for name, arr in self._columns.items():
            arr = to_host(arr)
            if arr.ndim == 2:
                width = arr.shape[1]
                flat = pa.array(arr.reshape(-1))
                arrays.append(pa.FixedSizeListArray.from_arrays(flat, width))
            else:
                arrays.append(pa.array(arr))
            names.append(name)
        return pa.Table.from_arrays(arrays, names=names)

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{n}:{a.dtype}{list(a.shape[1:])}" for n, a in self._columns.items()
        )
        return f"Frame[{self._num_rows} rows]({cols})"
