"""Collectives over the mesh: the ``treeAggregate`` analog.

Counterpart of ``sntc_tpu/parallel/collectives.py``.  Spark's
per-iteration triad (broadcast the parameters, a per-partition seqOp, a
tree-reduced combOp) is here: replicated arguments given whole to every
shard, ``fn`` run on each shard's rows on that shard's device, and the
partials reduced leaf by leaf in shard order on the first shard's
device (then all-reduced once when the mesh spans processes).

Rows are laid out as the JAX ``shard_batch`` lays them out: padded to
:func:`pad_rows` rows by repeating row 0, with a float32 weight column
that is 1 on real rows and 0 on the padding, and split into equal
contiguous blocks, one a shard.  Each block is its own contiguous
tensor on its shard's device (a :class:`ShardedArray`), made once per
fit: a later pass reads the block, never a strided view of the whole.

:func:`make_tree_aggregate` keeps the JAX aggregate's survival plane:

* the optional retry (``SNTC_COLLECTIVE_RETRIES``) and circuit breaker
  (``SNTC_COLLECTIVE_BREAKER[_COOLDOWN_S]``) around each dispatch, and
  the fault points ``collective.dispatch`` and ``mesh.resize``;
* the elastic resize: a ``device_lost`` shrinks the data axis to the
  largest power of two the padded batch divides over
  (:func:`_shrunk_axis_size`; ``SNTC_MESH_RESIZE=0`` turns it off),
  journals ``mesh_resize`` on the attached
  :class:`~sntc_tpu_torch.resilience.device.DeviceFaultDomain`, re-places
  the batch on the survivors and dispatches again; a batch placed for
  the old mesh is migrated when it next arrives;
* the ``device_oom`` split: the padded batch is cut into two
  shard-aligned halves whose partials are reduced together
  (``SNTC_COLLECTIVE_OOM_DEPTH`` bounds the depth without a domain).

Every placed byte is recorded in the active transfer ledgers
(``utils.profiling``) as an upload; a placement is not a dispatch.
Same-device placement reuses a numpy array's blocks while the array
lives (the device-residency cache, ``SNTC_DEVICE_CACHE_MB``).
"""

from __future__ import annotations

import os
import sys
import weakref
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from sntc_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    payload_nbytes,
    record_collective,
    record_mesh_shape,
    reduce_at,
)


def int_from_env(var: str, default: int, minimum: int = 0) -> int:
    """An integer knob from the environment; a malformed value warns
    once on stderr and gives ``default``."""
    raw = os.environ.get(var)
    if raw is None:
        return default
    try:
        val = int(raw)
    except (TypeError, ValueError):
        print(f"sntc_tpu_torch: malformed {var}={raw!r}; using {default}",
              file=sys.stderr)
        return default
    return max(minimum, val)


def _dispatch_breaker():
    """``SNTC_COLLECTIVE_BREAKER=1``: one process-wide breaker for site
    ``collective.dispatch`` (cooldown ``SNTC_COLLECTIVE_BREAKER_COOLDOWN_S``,
    default 30), so a backend that is down fails fast.  Off by default."""
    if int_from_env("SNTC_COLLECTIVE_BREAKER", 0) <= 0:
        return None
    from sntc_tpu_torch.resilience.circuit import breaker_for

    cooldown = int_from_env("SNTC_COLLECTIVE_BREAKER_COOLDOWN_S", 30)
    return breaker_for("collective.dispatch", cooldown_s=float(cooldown))


def _dispatch_policy():
    """``SNTC_COLLECTIVE_RETRIES=N``: N in-place retries with a
    deterministic backoff for dispatches that raise.  Default 0."""
    retries = int_from_env("SNTC_COLLECTIVE_RETRIES", 0, minimum=0)
    if retries <= 0:
        return None
    from sntc_tpu_torch.resilience.policy import RetryPolicy

    return RetryPolicy(max_attempts=retries + 1, base_delay_s=0.1,
                       multiplier=2.0, max_delay_s=10.0, jitter=0.1, seed=0)


_COLLECTIVE_DOMAIN = None


def set_collective_domain(domain) -> None:
    """Attach (or detach with ``None``) the process-wide device fault
    domain that the collective layer's survival decisions journal
    into."""
    global _COLLECTIVE_DOMAIN
    _COLLECTIVE_DOMAIN = domain


def get_collective_domain():
    return _COLLECTIVE_DOMAIN


def _resize_enabled() -> bool:
    return int_from_env("SNTC_MESH_RESIZE", 1) > 0


def _ledger_movement(nbytes: int) -> None:
    """One placement recorded as an upload (not a dispatch) in every
    active transfer ledger."""
    from sntc_tpu_torch.utils.profiling import record_movement

    record_movement(uploads=1, upload_bytes=int(nbytes))


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(getattr(a, "nbytes", 0))


class ShardedArray:
    """Rows ``[n_pad, ...]`` split over the data axis of ``mesh``:
    ``blocks[j]`` is the ``j``-th local shard's contiguous block on its
    device (every shard, in one process)."""

    def __init__(self, mesh: Mesh, blocks: list, n_rows: int):
        self.mesh = mesh
        self.blocks = list(blocks)
        self.n_rows = int(n_rows)

    @property
    def shape(self) -> tuple:
        return (self.n_rows,) + tuple(self.blocks[0].shape[1:])

    @property
    def ndim(self) -> int:
        return self.blocks[0].ndim

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(b) for b in self.blocks) * (
            self.mesh.shape[DATA_AXIS] // max(len(self.blocks), 1))

    def tensor(self, device=None) -> torch.Tensor:
        """All rows as one tensor on ``device`` (default the first
        shard's); one process only."""
        if self.mesh.spans_processes:
            raise ValueError("a mesh across processes has no whole array")
        dev = torch.device(device) if device is not None else \
            self.blocks[0].device
        return torch.cat([b.to(dev) for b in self.blocks])

    def numpy(self) -> np.ndarray:
        return self.tensor(torch.device("cpu")).numpy()


def place_rows(mesh: Mesh, arr, n_pad: Optional[int] = None,
               axis_name: str = DATA_AXIS) -> ShardedArray:
    """``arr`` (numpy or a tensor, ``n`` rows) padded to ``n_pad`` rows
    by repeating row 0 and split into one contiguous block a shard, each
    on its shard's device; ``n_pad`` must divide over the shards.  The
    placed bytes go to the active transfer ledgers."""
    n = int(arr.shape[0])
    n_pad = n if n_pad is None else int(n_pad)
    n_shards = int(mesh.shape[axis_name])
    if n_pad % n_shards:
        raise ValueError(f"{n_pad} rows do not divide over {n_shards} shards")
    if n_pad != n:
        if isinstance(arr, torch.Tensor):
            pad = arr[:1].expand((n_pad - n,) + tuple(arr.shape[1:]))
            arr = torch.cat([arr, pad])
        else:
            pad = np.broadcast_to(arr[:1], (n_pad - n,) + arr.shape[1:])
            arr = np.concatenate([arr, pad], axis=0)
    per = n_pad // n_shards
    devices = mesh.data_devices()
    blocks = []
    for s in mesh.local_shards():
        part = arr[s * per:(s + 1) * per]
        if isinstance(part, torch.Tensor):
            blocks.append(part.to(devices[s]).contiguous())
        else:
            blocks.append(torch.from_numpy(np.ascontiguousarray(part))
                          .to(devices[s]))
    _ledger_movement(_nbytes(arr))
    return ShardedArray(mesh, blocks, n_pad)


# -- the device-residency cache --------------------------------------------

_DEVICE_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()


def _device_cache_max_bytes() -> int:
    return int(os.environ.get("SNTC_DEVICE_CACHE_MB", "2048")) * (1 << 20)


def _cached_shard_put(arr, n_pad: int, mesh: Mesh,
                      axis_name: str) -> ShardedArray:
    """:func:`place_rows`, memoized on the identity of the unpadded
    numpy array (a weak reference: a dropped array drops its entry)."""
    cacheable = (isinstance(arr, np.ndarray) and arr.nbytes >= (1 << 20)
                 and _device_cache_max_bytes() > 0)
    for k in [k for k, e in _DEVICE_CACHE.items() if e[0]() is None]:
        del _DEVICE_CACHE[k]
    key = (id(arr), n_pad, mesh, axis_name)
    if cacheable:
        hit = _DEVICE_CACHE.get(key)
        if hit is not None and hit[0]() is arr:
            _DEVICE_CACHE.move_to_end(key)
            return hit[1]
    out = place_rows(mesh, arr, n_pad, axis_name)
    if cacheable:
        try:
            ref = weakref.ref(arr)
        except TypeError:
            return out
        _DEVICE_CACHE[key] = (ref, out)
        total = sum(e[1].nbytes for e in _DEVICE_CACHE.values())
        while total > _device_cache_max_bytes() and len(_DEVICE_CACHE) > 1:
            _, old = _DEVICE_CACHE.popitem(last=False)
            total -= old[1].nbytes
    return out


def pad_rows(n: int, n_shards: int) -> int:
    """Rows after padding ``n`` up to a multiple of ``n_shards``, then
    up to a shape bucket (the per-shard count rounded to 1/64 of its
    leading bit), as in the JAX package; ``SNTC_SHAPE_BUCKETS=0`` keeps
    the exact multiple."""
    m = ((n + n_shards - 1) // n_shards) * n_shards
    per = m // n_shards
    if per <= 64 or os.environ.get("SNTC_SHAPE_BUCKETS", "1") == "0":
        return m
    q = 1 << (per.bit_length() - 6)
    per = ((per + q - 1) // q) * q
    return per * n_shards


def shard_batch(mesh: Mesh, *arrays, axis_name: str = DATA_AXIS):
    """Pad and place ``arrays`` (numpy or tensors, one row count)
    row-sharded over the mesh.  Returns ``(*sharded, weights)``:
    ``weights`` is float32 ``[n_pad]``, 1 on real rows and 0 on the
    padding, which repeats row 0."""
    n = arrays[0].shape[0]
    n_pad = pad_rows(n, int(mesh.shape[axis_name]))
    out = []
    for arr in arrays:
        if arr.shape[0] != n:
            raise ValueError("all arrays must share the leading dimension")
        out.append(_cached_shard_put(arr, n_pad, mesh, axis_name))
    weights = np.zeros(n_pad, dtype=np.float32)
    weights[:n] = 1.0
    out.append(place_rows(mesh, weights, axis_name=axis_name))
    return tuple(out)


def shard_weights(mesh: Mesh, w, n_padded: int,
                  axis_name: str = DATA_AXIS) -> ShardedArray:
    """Row weights ``w`` padded with zeros to ``n_padded`` and sharded:
    the companion of :func:`shard_batch` for a caller's own weights."""
    w_pad = np.zeros(n_padded, dtype=np.float32)
    w_pad[: len(w)] = np.asarray(w, np.float32)
    return place_rows(mesh, w_pad, axis_name=axis_name)


def _shrunk_axis_size(survivors: int, n_pad: int) -> int:
    """Largest power-of-two shard count ≤ ``survivors`` that the padded
    batch still divides over (1 always does)."""
    c = 1 << max(0, survivors.bit_length() - 1)
    while c > 1 and n_pad % c:
        c //= 2
    return max(1, c)


def make_tree_aggregate(fn: Callable, mesh: Mesh,
                        axis_name: str = DATA_AXIS, check_vma: bool = True,
                        replicated_args: tuple = (),
                        op: str = "tree_aggregate",
                        combine="sum") -> Callable:
    """Build ``agg(*arrays) -> tree``: ``fn`` on every shard's rows,
    the partial trees reduced leaf by leaf in shard order — summed, or
    per ``combine`` (``"min"``, ``"max"``, or a tree of names matching
    the outputs) — on the mesh's first local device, then across its
    processes.

    Positions in ``replicated_args`` are given whole to every shard (on
    its device); the others are row-sharded: a :class:`ShardedArray`
    from :func:`shard_batch`, or an array whose rows divide the mesh.
    ``fn``'s outputs must reduce over any row partition
    (``fn(rows) == fn(rows[:k]) ⊕ fn(rows[k:])``): the OOM split relies
    on it.  ``op`` labels the ``sntc_collective_*`` series.  Build once
    per fit and call per iteration: the resize state lives here."""
    state = {"mesh": mesh, "resized": False}
    record_mesh_shape(mesh)

    def _rows(arrays) -> list:
        return [i for i in range(len(arrays)) if i not in replicated_args]

    def _place_on(m: Mesh, arrays: tuple) -> tuple:
        """Re-place the row-sharded arguments on mesh ``m`` through the
        host (the duress paths only; every byte goes to the ledgers)."""
        out = list(arrays)
        for i in _rows(arrays):
            a = arrays[i]
            host = a.numpy() if isinstance(a, ShardedArray) else a
            out[i] = place_rows(m, host, axis_name=axis_name)
        return tuple(out)

    def _ensure_on(m: Mesh, arrays: tuple) -> tuple:
        """Batches placed on the mesh before a resize migrate onto the
        live one when they arrive."""
        if not state["resized"]:
            return arrays
        for i in _rows(arrays):
            a = arrays[i]
            if isinstance(a, ShardedArray) and a.mesh != m:
                return _place_on(m, arrays)
        return arrays

    def _compute(m: Mesh, arrays: tuple):
        devices = m.data_devices()
        parts = []
        for j, s in enumerate(m.local_shards()):
            args = []
            for i, a in enumerate(arrays):
                if i in replicated_args:
                    if isinstance(a, np.ndarray):
                        a = torch.from_numpy(np.ascontiguousarray(a))
                    args.append(a.to(devices[s])
                                if isinstance(a, torch.Tensor) else a)
                else:
                    if not isinstance(a, ShardedArray):
                        a = place_rows(m, a, axis_name=axis_name)
                    args.append(a.blocks[j])
            parts.append(fn(*args))
        return reduce_at(parts, axis_name, mesh=m, combine=combine)

    def _oom_depth_limit() -> int:
        dom = get_collective_domain()
        if dom is not None:
            return dom.policy.oom_split_depth
        return int_from_env("SNTC_COLLECTIVE_OOM_DEPTH", 4, minimum=1)

    def _resize(exc: BaseException, arrays: tuple) -> tuple:
        """Shrink the data axis onto the survivors and re-place the
        batch there; ``exc`` again when no resize is possible (one
        shard, disabled, or a mesh across processes)."""
        from sntc_tpu_torch.resilience.faults import fault_point

        old = state["mesh"]
        old_n = int(old.shape[axis_name])
        if old_n <= 1 or not _resize_enabled() or old.spans_processes:
            raise exc
        rows = _rows(arrays)
        n_pad = int(arrays[rows[0]].shape[0]) if rows else 1
        new_n = _shrunk_axis_size(old_n - 1, n_pad)
        fault_point("mesh.resize")
        # the survivors are the leading entries of the data axis: the
        # runtime does not name the lost device, so the tail goes
        new_mesh = old.take_data(new_n)
        state["mesh"] = new_mesh
        state["resized"] = True
        try:
            from sntc_tpu_torch.obs.metrics import inc

            inc("sntc_collective_resizes_total")
        except Exception:
            pass
        record_mesh_shape(new_mesh)
        dom = get_collective_domain()
        if dom is not None:
            dom.note_mesh_resize(old=old_n, new=new_n, axis=axis_name,
                                 site="collective.dispatch")
        else:
            from sntc_tpu_torch.resilience.policy import emit_event

            emit_event(event="mesh_resize", component="model",
                       site="collective.dispatch", axis=axis_name,
                       old=old_n, new=new_n)
        return _place_on(new_mesh, arrays)

    def _split(arrays: tuple, depth: int, exc: BaseException):
        """The ``device_oom`` responder: two shard-aligned row halves,
        their partials reduced together."""
        m = state["mesh"]
        n_shards = int(m.shape[axis_name])
        rows = _rows(arrays)
        if not rows or depth >= _oom_depth_limit():
            raise exc
        n_pad = int(arrays[rows[0]].shape[0])
        if n_pad < 2 * n_shards:
            raise exc  # one row a shard already
        cut = ((n_pad // 2 + n_shards - 1) // n_shards) * n_shards
        host = {i: (arrays[i].numpy() if isinstance(arrays[i], ShardedArray)
                    else arrays[i]) for i in rows}
        from sntc_tpu_torch.resilience.device import release_frames

        release_frames(exc)
        halves = []
        for sl in (slice(0, cut), slice(cut, n_pad)):
            part = list(arrays)
            for i in rows:
                part[i] = place_rows(m, host[i][sl], axis_name=axis_name)
            halves.append(tuple(part))
        dom = get_collective_domain()
        if dom is not None:
            dom.note_oom_split(rows=n_pad, depth=depth + 1,
                               bucket_floor=n_shards)
        first = _run(halves[0], depth + 1)
        second = _run(halves[1], depth + 1)
        from sntc_tpu_torch.parallel.mesh import _combine_leafwise

        return _combine_leafwise(first, second, combine)

    def _run(arrays: tuple, depth: int = 0):
        from sntc_tpu_torch.resilience.device import classify_device_error
        from sntc_tpu_torch.resilience.faults import fault_point

        m = state["mesh"]
        arrays = _ensure_on(m, arrays)
        try:
            fault_point("collective.dispatch")
            out = _compute(m, arrays)
        except Exception as e:  # noqa: BLE001 — classified below
            kind = classify_device_error(e)
            if kind == "device_lost":
                return _run(_resize(e, arrays), depth)
            if kind == "device_oom":
                return _split(arrays, depth, e)
            raise
        record_collective(op, axis_name, int(m.shape[axis_name]),
                          payload_nbytes(out))
        return out

    policy = _dispatch_policy()
    breaker = _dispatch_breaker()

    def dispatch(*arrays):
        from sntc_tpu_torch.resilience.circuit import CircuitOpenError

        if breaker is not None and not breaker.allow():
            raise CircuitOpenError("collective.dispatch",
                                   breaker.retry_after_s())
        try:
            if policy is None:
                out = _run(tuple(arrays))
            else:
                from sntc_tpu_torch.resilience.policy import with_retries

                out = with_retries(lambda: _run(tuple(arrays)), policy,
                                   site="collective.dispatch")
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            breaker.record_success()
        return out

    dispatch.mesh = lambda: state["mesh"]  # type: ignore[attr-defined]
    return dispatch


def tree_aggregate(fn: Callable, mesh: Mesh, *arrays,
                   axis_name: str = DATA_AXIS):
    """One-shot :func:`make_tree_aggregate` (an iterating caller builds
    once and reuses)."""
    return make_tree_aggregate(fn, mesh, axis_name)(*arrays)


# -- the estimators' side ---------------------------------------------------


def fit_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh a fit shards over, or ``None`` for the single-device
    path: no mesh, or one shard in one process (which pads nothing and
    keeps the single-device reduction order, so its results are the
    single-device fit's bitwise)."""
    if mesh is None:
        return None
    if int(mesh.shape[DATA_AXIS]) == 1 and not mesh.spans_processes:
        return None
    return mesh


def fit_rows(X: np.ndarray, y: np.ndarray, w: np.ndarray, device,
             mesh: Optional[Mesh]) -> tuple:
    """A supervised fit's ``(xs, ys, ws)``: the rows, the labels as
    int64 and the row weights on ``device`` without a mesh, else laid
    out by :func:`shard_batch` over ``mesh`` (the weights zero on the
    padding)."""
    if mesh is None:
        return (torch.from_numpy(np.require(X, requirements=["C", "W"]))
                .to(device), torch.from_numpy(y.astype(np.int64)).to(device),
                torch.from_numpy(w).to(device))
    xs, ys, _ = shard_batch(mesh, X, y.astype(np.int64))
    return xs, ys, shard_weights(mesh, w, xs.shape[0])


def fit_device(device, mesh: Optional[Mesh]) -> torch.device:
    """An estimator's device: ``device`` (default ``cuda``) without a
    mesh; with one, the mesh's first local device, which an explicit
    ``device`` must name."""
    from sntc_tpu_torch.device import resolve_device

    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    home = resolve_device(mesh.first_device)
    if device is not None:
        dev = torch.device(device)
        if dev.type != home.type or (
                dev.index is not None and dev.index != (home.index or 0)):
            raise ValueError(
                f"device {str(dev)!r} is not the mesh's first local device "
                f"{str(home)!r}: a fitted model's tensors live there")
    return home

