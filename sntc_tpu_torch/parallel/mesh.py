"""The mesh substrate: one parallelism API for the port.

Counterpart of ``sntc_tpu/parallel/mesh.py``.  A :class:`Mesh` is an
array of ``torch.device`` entries, ``[data]`` or ``[data, model]``, with
its axis names.  Rows shard over the ``"data"`` axis; each entry of that
axis is one shard.  A device may appear more than once: the shards are
then *virtual*, computed one after the other on the same device (the
counterpart of the JAX package's faked CPU devices, and the only way to
run a mesh wider than one shard on a host with one card).  A mesh whose
entries belong to several processes also holds the process group its
reductions ``all_reduce`` over, and which process owns each entry.

Mesh construction:

* :func:`default_mesh` — 1-D ``("data",)`` over the first ``n`` visible
  devices of a type (``n`` virtual CPU shards on the CPU);
* :func:`make_mesh` — 2-D ``("data", "model")`` over an explicit or the
  visible device list;
* :func:`hybrid_mesh` — the multi-process path: ranks stack along the
  outer data axis (one process degrades to :func:`make_mesh`).

The primitives are the JAX package's DrJAX shape without a tracer: torch
runs eagerly, so a body cannot ``psum`` halfway through.
:func:`map_at` runs ``fn`` on each local shard's block on that shard's
device; an output whose spec names the data axis is concatenated by
rows, a replicated one (``P()``) is summed across the shards.
:func:`reduce_at` sums a list of per-shard trees in shard order on the
first tree's device, then all-reduces the sum once across the
mesh's processes (every leaf packed into one buffer).

The evidence plane is the JAX package's: every collective dispatch
counts into ``sntc_collective_dispatches_total`` and the ring
all-reduce's wire bytes into ``sntc_collective_bytes_moved_total``; the
mesh shape is the ``sntc_collective_mesh_devices`` gauge.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

#: Axis-name registry: every mesh axis the port may declare, with its
#: role (the JAX package's names and meanings).
MESH_AXES = {
    "data": (
        "batch rows — the RDD-partition analog; batches shard over it, "
        "reductions psum over it (SURVEY.md §5.8)"
    ),
    "model": (
        "parameter shards for wide layers — absent upstream (SURVEY.md "
        "§2.5) but plumbed for the multichip dryrun and future growth"
    ),
}

DATA_AXIS = "data"
MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """Placement of an array's axes over mesh axes: ``P("data", None)``
    shards rows over ``"data"``, ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


class Mesh:
    """``devices`` (an array of ``torch.device``) named by
    ``axis_names``.  ``ranks`` (same shape) says which process owns each
    entry, all this process's when omitted; ``group`` is the process
    group reductions across processes run on (``None``: the default
    group).  ``distributed`` makes every reduction ``all_reduce`` over
    that group even when the mesh's entries are all this process's (a
    one-rank group)."""

    def __init__(self, devices, axis_names: Sequence[str] = (DATA_AXIS,),
                 ranks=None, group=None, rank: Optional[int] = None,
                 distributed: bool = False):
        flat = [torch.device(d) for d in np.asarray(devices, object).flat]
        shape = np.asarray(devices, object).shape
        arr = np.empty(len(flat), object)
        arr[:] = flat
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"devices of shape {shape} do not match axes "
                f"{self.axis_names}")
        if ranks is None:  # every entry is this process's
            ranks, rank = np.zeros(shape, np.int64), 0
        self.ranks = np.asarray(ranks, np.int64).reshape(shape)
        self.rank = int(rank if rank is not None else _process_index())
        self.group = group
        self.distributed = bool(distributed)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _data_column(self, arr):
        ax = self.axis_names.index(DATA_AXIS)
        take = [0] * arr.ndim
        take[ax] = slice(None)
        return list(arr[tuple(take)])

    def data_devices(self) -> list:
        """The device of each shard along the data axis (its first model
        entry)."""
        return self._data_column(self.devices)

    def data_ranks(self) -> list:
        return [int(r) for r in self._data_column(self.ranks)]

    def local_shards(self) -> list:
        """The data-axis indices this process computes."""
        return [i for i, r in enumerate(self.data_ranks()) if r == self.rank]

    @property
    def spans_processes(self) -> bool:
        """True when reductions go across processes."""
        return self.distributed or len(set(int(r) for r in self.ranks.flat)) > 1

    @property
    def first_device(self) -> torch.device:
        """The first local shard's device: where reductions land and a
        fitted model's tensors live."""
        return self.data_devices()[self.local_shards()[0]]

    def take_data(self, n: int) -> "Mesh":
        """The mesh of the leading ``n`` entries along the data axis."""
        ax = self.axis_names.index(DATA_AXIS)
        take = [slice(None)] * self.devices.ndim
        take[ax] = slice(0, n)
        return Mesh(self.devices[tuple(take)], self.axis_names,
                    self.ranks[tuple(take)], self.group, self.rank,
                    self.distributed)

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat), self.devices.shape,
                self.axis_names, tuple(int(r) for r in self.ranks.flat),
                self.rank, id(self.group), self.distributed)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def _process_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _visible(device_type: str) -> list:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA mesh was asked for but CUDA is not available; pass "
                "device='cpu' for virtual CPU shards")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type != "cpu":
        raise ValueError(f"unsupported device type {device_type!r}")
    return None  # the CPU has as many virtual shards as asked for


def default_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """1-D ``("data",)`` mesh over the first ``n_devices`` visible
    devices of ``device``'s type (all of them when ``None``); a device
    with an index (``"cuda:1"``) gives that one device.  On the CPU it
    gives ``n_devices`` virtual shards, one when ``None``."""
    dev = torch.device(device)
    visible = _visible(dev.type)
    if visible is None:
        return Mesh([dev] * (n_devices or 1), (DATA_AXIS,))
    if dev.index is not None and n_devices is None:
        if dev.index >= len(visible):
            raise ValueError(f"device {dev} is not visible")
        return Mesh([dev], (DATA_AXIS,))
    if n_devices is not None:
        if n_devices > len(visible):
            raise ValueError(
                f"requested {n_devices} devices, only {len(visible)} "
                "available")
        visible = visible[:n_devices]
    return Mesh(visible, (DATA_AXIS,))


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """2-D ``(data, model)`` mesh.  ``data=-1`` means all the devices
    left; ``devices`` defaults to the visible CUDA devices and may name
    a device more than once (virtual shards)."""
    devs = list(_visible("cuda") if devices is None else devices)
    if data == -1:
        if len(devs) % model:
            raise ValueError(
                f"{len(devs)} devices not divisible by model={model}")
        data = len(devs) // model
    devs = devs[: data * model]
    if len(devs) != data * model:
        raise ValueError(
            f"need {data * model} devices for mesh ({data},{model}), "
            f"have {len(devs)}")
    arr = np.empty(len(devs), object)
    arr[:] = [torch.device(d) for d in devs]
    return Mesh(arr.reshape(data, model), (DATA_AXIS, MODEL_AXIS))


def hybrid_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    """Multi-process ``(data, model)`` mesh: every rank contributes its
    local devices (``devices``, default the visible CUDA devices) and
    the ranks stack along the outer data axis, rank-major.  One process
    degrades to :func:`make_mesh`."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return make_mesh(data=data, model=model, devices=devices)
    return process_mesh(data, model, devices)


def process_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    """The ``(data, model)`` mesh over every rank of the initialized
    process group (a one-rank group too), ranks stacked along the data
    axis; its reductions ``all_reduce`` over the group."""
    dist = torch.distributed
    local = [str(torch.device(d)) for d in
             (_visible("cuda") if devices is None else devices)]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    devs, ranks = [], []
    for r, lst in enumerate(gathered):
        devs += [torch.device(d) for d in lst]
        ranks += [r] * len(lst)
    n = len(devs)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    procs = dist.get_world_size()
    if data % procs:
        raise ValueError(
            f"data={data} not divisible by process count {procs} — the "
            "hybrid mesh stacks whole processes along the data axis")
    arr = np.empty(data * model, object)
    arr[:] = devs[: data * model]
    return Mesh(arr.reshape(data, model), (DATA_AXIS, MODEL_AXIS),
                ranks=np.asarray(ranks[: data * model]).reshape(data, model),
                rank=dist.get_rank(), distributed=True)


class NamedSharding:
    """A placement descriptor: ``mesh`` and the ``spec`` of an array's
    axes.  :func:`~sntc_tpu_torch.parallel.collectives.shard_batch`
    places rows by it."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    @property
    def is_fully_replicated(self) -> bool:
        return not any(a is not None for a in self.spec)


def data_sharding(mesh: Mesh, rank: int = 1) -> NamedSharding:
    """Shard the leading (row) axis over "data"; replicate the rest."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (rank - 1))))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# -- trees of tensors -------------------------------------------------------


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


_COMBINE = {
    "sum": lambda a, b: a + b,
    "min": torch.minimum,
    "max": torch.maximum,
}


def _dist_op(name: str):
    ops = torch.distributed.ReduceOp
    return {"sum": ops.SUM, "min": ops.MIN, "max": ops.MAX}[name]


def _combine_leafwise(a, b, combine):
    """``a ⊕ b`` leaf by leaf, ``combine`` a name or a tree of names
    matching the outputs (a name for every leaf when it is one)."""
    if isinstance(combine, str):
        return tree_map(_COMBINE[combine], a, b)
    return tree_map(lambda x, y, c: _COMBINE[c](x, y), a, b, combine)


def all_reduce_tree(tree, mesh: Mesh, combine="sum"):
    """``tree`` reduced across the mesh's processes: one ``all_reduce``
    per (reduction, dtype) over the leaves packed into one buffer."""
    leaves = tree_leaves(tree)
    ops = (tree_leaves(combine) if not isinstance(combine, str)
           else [combine] * len(leaves))
    groups = {}
    for i, (leaf, op) in enumerate(zip(leaves, ops)):
        groups.setdefault((op, leaf.dtype), []).append(i)
    out = list(leaves)
    for (op, _dtype), idx in groups.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        torch.distributed.all_reduce(flat, op=_dist_op(op), group=mesh.group)
        off = 0
        for i in idx:
            k = leaves[i].numel()
            out[i] = flat[off:off + k].reshape(leaves[i].shape)
            off += k
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def reduce_at(trees, axis_name: str = DATA_AXIS, mesh: Optional[Mesh] = None,
              combine="sum"):
    """Reduce the per-shard trees ``trees`` (one a local shard, in shard
    order) leaf by leaf on the first tree's device — summed by default,
    or per ``combine`` (``"min"``/``"max"``, or a tree of names) — then
    across the mesh's processes when it spans several.  One tree comes
    back as it is."""
    trees = list(trees)
    home = tree_leaves(trees[0])[0].device
    out = trees[0]
    for t in trees[1:]:
        out = _combine_leafwise(out, tree_map(lambda x: x.to(home), t),
                                combine)
    if mesh is not None and mesh.spans_processes:
        out = all_reduce_tree(out, mesh, combine)
    return out


def _shard_arg(arg, spec, mesh: Mesh, i: int):
    """Shard ``i`` (a position among the local shards) of one argument
    of a mapped call."""
    from sntc_tpu_torch.parallel.collectives import ShardedArray, place_rows

    dev = mesh.data_devices()[mesh.local_shards()[i]]
    if spec is not None and len(spec) and spec[0] is not None:
        if not isinstance(arg, ShardedArray):
            arg = place_rows(mesh, arg)
        return arg.blocks[i]
    if isinstance(arg, np.ndarray):
        arg = torch.from_numpy(np.ascontiguousarray(arg))
    if isinstance(arg, torch.Tensor):
        return arg.to(dev)
    return arg


def map_at(mesh: Mesh, fn: Callable, *, in_specs, out_specs,
           check_vma: bool = True, jit: bool = True):
    """Run ``fn`` on every local shard: row-sharded arguments (a spec
    naming the data axis) give each shard its block, the others are
    given whole on the shard's device.  An output under a data-axis spec
    is concatenated by rows on the first local device; one under ``P()``
    is summed across the shards (and processes).  ``check_vma`` and
    ``jit`` are the JAX signature's; eager torch has nothing to check or
    trace."""

    def mapped(*args):
        shards = mesh.local_shards()
        specs = (tuple(in_specs) if isinstance(in_specs, (list, tuple))
                 and not _is_spec(in_specs) else (in_specs,) * len(args))
        outs = [fn(*(_shard_arg(a, s, mesh, i)
                     for a, s in zip(args, specs)))
                for i in range(len(shards))]
        return _gather_outputs(outs, out_specs, mesh)

    return mapped


def _gather_outputs(outs, out_specs, mesh: Mesh):
    if _is_spec(out_specs):
        if len(out_specs) and out_specs[0] is not None:
            home = mesh.first_device
            if mesh.spans_processes:
                raise ValueError(
                    "row-sharded outputs stay per process on a mesh "
                    "across processes; reduce them with P()")
            return tree_map(lambda *xs: torch.cat([x.to(home) for x in xs]),
                            *outs)
        return reduce_at(outs, mesh=mesh)
    # a tuple of specs, one an output
    parts = [_gather_outputs([o[j] for o in outs], s, mesh)
             for j, s in enumerate(out_specs)]
    return tuple(parts)


def map_reduce_at(mesh: Mesh, fn: Callable, *, axis_name: str = DATA_AXIS,
                  in_specs, out_specs=P(), check_vma: bool = True,
                  jit: bool = False):
    """:func:`map_at` with every output summed over ``axis_name``: the
    building block under ``collectives.make_tree_aggregate``."""
    return map_at(mesh, fn, in_specs=in_specs, out_specs=P(),
                  check_vma=check_vma, jit=jit)


def sharded_jit(fun: Callable, in_shardings=None, out_shardings=None,
                **jit_kwargs):
    """``fun`` unchanged: eager torch has no partitioner to annotate.
    Kept so that the exported names match the JAX package's."""
    return fun


# -- the evidence plane -----------------------------------------------------


def collective_wire_bytes(n_shards: int, payload_bytes: int) -> int:
    """Ring all-reduce cost model: reducing a payload of
    ``payload_bytes`` across ``n_shards`` moves ``2·(n-1)·payload`` on
    the wire in all; one shard moves nothing."""
    if n_shards <= 1:
        return 0
    return 2 * (n_shards - 1) * int(payload_bytes)


def record_collective(op: str, axis_name: str, n_shards: int,
                      payload_bytes: int) -> None:
    """Count one collective dispatch and its wire bytes."""
    try:
        from sntc_tpu_torch.obs.metrics import inc

        inc("sntc_collective_dispatches_total", op=op, axis=axis_name)
        wire = collective_wire_bytes(n_shards, payload_bytes)
        if wire:
            inc("sntc_collective_bytes_moved_total", wire, op=op,
                axis=axis_name)
    except Exception:
        pass


def record_mesh_shape(mesh: Mesh) -> None:
    """Mirror the mesh shape into the per-axis device gauge."""
    try:
        from sntc_tpu_torch.obs.metrics import set_gauge

        for axis_name, size in mesh.shape.items():
            set_gauge("sntc_collective_mesh_devices", size, axis=axis_name)
    except Exception:
        pass


def payload_nbytes(tree) -> int:
    """Bytes of every leaf of ``tree`` (tensors and numpy arrays)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        else:
            total += int(getattr(t, "nbytes", 0))
    return total
