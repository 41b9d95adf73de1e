"""pad_assemble — bucket padding for the serve path, a CUDA kernel for Hopper.

Counterpart of ``sntc_tpu/kernels/assemble.py`` (``pad_rows_pallas``, the
Pallas kernel ``_pad_kernel``, driven per column by ``pad_assemble``).
``BatchPredictor`` rounds a batch up to its shape bucket by repeating the
last row and attaches a ``VALID_COL`` mask marking the real rows.

:func:`pad_rows` pads one ``[N, C]`` block, row-major or column-major
(strides ``(1, N)``: the transpose of a contiguous ``[C, N]`` block), into
a contiguous row-major ``[target, C]`` block: on a CUDA tensor it
launches ``csrc/pad_rows.cu`` (:func:`pad_rows_cuda`) or raises; on a CPU
tensor it computes :func:`pad_rows_reference`.  Both are bitwise the
numpy repeat-last-row twin.

:func:`pad_assemble` does not pad column by column as the JAX package
does: a CICIDS2017 batch has 78 numeric columns, and a host→device→host
round trip per column would dominate the batch.  It packs the 1-D
numeric columns of one item size (float64 and int64; float32 and int32)
column-major into one ``[C, N]`` block, one contiguous copy per column
(a row-major pack would store each column with strided writes, on the
engine thread, for every batch), uploads it once, and pads its
transpose in one launch: the kernel transposes on the device.  The
padded row-major block stays on the device; each column of the padded
frame is a view of it, in its own dtype (the copy moves bits, so an
integer column rides a float block exactly).  The assembled features
then reach the serve kernels without a second upload, and a CSV batch
costs one upload (recorded in the transfer ledger).  A 2-D float column
(a row-major ``[N, k]`` block) pads on its own, as it is; other columns
pad on the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.kernels import _build
from sntc_tpu_torch.obs.metrics import inc
from sntc_tpu_torch.utils.profiling import upload

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
# numeric column dtypes padded on the device, by the float dtype of the
# block that carries their bits
_BLOCK_OF = {
    np.dtype(np.float64): np.float64, np.dtype(np.int64): np.float64,
    np.dtype(np.float32): np.float32, np.dtype(np.int32): np.float32,
}
_TORCH_OF = {
    np.dtype(np.float64): torch.float64, np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
}
_NP_FLOATS = (np.float32, np.float64)


def _pad_column_np(a: np.ndarray, target: int) -> np.ndarray:
    """The numpy repeat-last-row twin (the JAX package's
    ``Frame.pad_rows`` on one column)."""
    pad = target - a.shape[0]
    tail = np.broadcast_to(a[-1:], (pad,) + a.shape[1:])
    return np.concatenate([a, tail])


def pad_rows_reference(a: torch.Tensor, target: int) -> torch.Tensor:
    """Plain version: the block followed by ``target - N`` copies of its
    last row, as a contiguous row-major block."""
    _check(a, target)
    n = a.shape[0]
    return torch.cat(
        [a, a[n - 1:].expand(target - n, *a.shape[1:])]).contiguous()


def _check(a: torch.Tensor, target: int) -> bool:
    """Refuse what the kernel does not take; True for a column-major
    block."""
    if a.ndim != 2:
        raise ValueError(f"pad_rows takes an [N, C] block, got {tuple(a.shape)}")
    if a.shape[0] < 1:
        raise ValueError("cannot pad an empty block (no row to repeat)")
    if target < a.shape[0]:
        raise ValueError(f"pad target {target} < {a.shape[0]} rows")
    if a.dtype not in _DTYPES:
        raise TypeError(f"pad_rows takes float32 or float64, got {a.dtype}")
    if a.is_contiguous():
        return False
    if a.stride() == (1, a.shape[0]):  # a.t() is contiguous
        return True
    raise ValueError("pad_rows takes a row-major or a column-major block, "
                     f"got strides {a.stride()} for shape {tuple(a.shape)}")


#: the widest block the kernel takes: 16 bytes of each of its columns
#: must fit in an SM's shared memory
MAX_COLUMNS = 227 * 1024 // 16
_ENTRIES: Dict[torch.dtype, object] = {}
_SHAPE_KEYS: Dict[tuple, str] = {}


def pad_launch_shape(n: int, c: int, dtype: torch.dtype, target: int) -> str:
    """The key :data:`~sntc_tpu_torch.kernels._build.PAD_LAUNCH_SHAPES`
    counts a launch under."""
    return f"[{n}, {c}] {_DTYPES[dtype]} -> {target}"


def _entry(dtype: torch.dtype):
    fn = _ENTRIES.get(dtype)
    if fn is None:
        fn = _ENTRIES[dtype] = getattr(_build.library(),
                                       f"sntc_pad_rows_{_DTYPES[dtype]}")
    return fn


def pad_rows_cuda(a: torch.Tensor, target: int) -> torch.Tensor:
    """Launch the CUDA kernel on a row-major or column-major ``[N, C]``
    CUDA block; the result is a contiguous row-major ``[target, C]``
    block.  The host's share of a call is kept small: the entry point is
    looked up once per dtype, the device context is entered only for a
    block off the current device, and the shape key is built once per
    shape."""
    col_major = _check(a, target)
    if not a.is_cuda:
        raise ValueError(f"block is not on a CUDA device: {a.device}")
    n, c = a.shape
    if c > MAX_COLUMNS:
        raise ValueError(f"pad_rows takes at most {MAX_COLUMNS} columns, "
                         f"got {c}")
    out = a.new_empty((target, c))
    if c == 0:
        return out
    dtype = a.dtype
    fn = _entry(dtype)
    index = a.get_device()
    args = (a.data_ptr(), out.data_ptr(), n, c, int(target), col_major)
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        _build.check_launch(_build.library(), err, "pad_assemble")
    _build.LAUNCHES["pad_assemble"] += 1
    inc("sntc_kernel_dispatch_total", kernel="pad_assemble", impl="cuda")
    key = (n, c, dtype, target)
    shape = _SHAPE_KEYS.get(key)
    if shape is None:
        shape = _SHAPE_KEYS[key] = pad_launch_shape(n, c, dtype, target)
    shapes = _build.PAD_LAUNCH_SHAPES
    shapes[shape] = shapes.get(shape, 0) + 1
    return out


def pad_rows(a: torch.Tensor, target: int) -> torch.Tensor:
    """Pad ``[N, C]`` (row-major or column-major) to a contiguous
    ``[target, C]`` by repeating the last row: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if a.device.type == "cuda":
        return pad_rows_cuda(a, target)
    if a.device.type == "cpu":
        inc("sntc_kernel_dispatch_total", kernel="pad_assemble",
            impl="plain")
        return pad_rows_reference(a, target)
    raise ValueError(f"unsupported device {a.device}")


def pad_assemble(frame: Frame, target: int, valid: np.ndarray,
                 device) -> Frame:
    """Bucket-pad ``frame`` to ``target`` rows by repeating its last row
    and attach the ``VALID_COL`` mask, with the numeric columns padded on
    ``device`` (see the module docs).  Column order and dtypes are
    kept."""
    from sntc_tpu_torch.serve.transform import VALID_COL

    device = torch.device(device)
    n = frame.num_rows
    host = {name: to_host(frame[name]) for name in frame.columns}
    cols: Dict[str, object] = dict.fromkeys(host)  # keeps the order
    groups: Dict[type, List[str]] = {}
    for name, a in host.items():
        if n == 0:
            cols[name] = _pad_column_np(a, target)
        elif a.ndim == 1 and a.dtype in _BLOCK_OF:
            groups.setdefault(_BLOCK_OF[a.dtype], []).append(name)
        elif a.ndim == 2 and a.dtype in _NP_FLOATS:
            cols[name] = pad_rows(
                upload(np.ascontiguousarray(a), device), target)
        else:
            cols[name] = _pad_column_np(a, target)
    for block_dtype, names in groups.items():
        # one upload and one launch for every column of this item size
        # (up to the kernel's widest block): the block is packed
        # column-major, one contiguous copy a column, and the kernel
        # transposes it; an integer column is stored as its bits
        for at in range(0, len(names), MAX_COLUMNS):
            part = names[at:at + MAX_COLUMNS]
            block_t = np.empty((len(part), n), block_dtype)
            for j, name in enumerate(part):
                block_t.view(host[name].dtype)[j] = host[name]
            padded = pad_rows(upload(block_t, device).t(), target)
            for j, name in enumerate(part):
                cols[name] = padded[:, j].view(_TORCH_OF[host[name].dtype])
    cols[VALID_COL] = np.asarray(valid, dtype=bool)
    return Frame._wrap(cols, int(target))
