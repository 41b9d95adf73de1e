"""The port's kernels against the JAX package's, on the CPU.

``forest_traversal``, ``pad_assemble`` and ``tree_hist`` are CUDA
kernels in ``sntc_tpu_torch``; here, where there is no card, their
wrappers compute the plain PyTorch versions, which are held against the
JAX package's XLA twin and its Pallas kernels in interpret mode.  The
first two only compare and copy, so every comparison is bitwise.
``tree_hist`` sums: with integer-valued stats every sum is exact and the
comparison is bitwise; with fractional stats it is the Pallas kernel's
own tolerance, 1e-5.  The tests marked ``cuda`` hold the CUDA kernels
against the plain versions on a card and skip without one.
"""

import io
import os
import re
import tokenize

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.kernels.assemble import _pad_column_np, pad_rows_pallas
from sntc_tpu.kernels.forest import forest_leaf_stats_pallas
from sntc_tpu.models.tree.grower import forest_leaf_stats as jax_forest
from sntc_tpu.ops.pallas_histogram import level_histogram_pallas
from sntc_tpu.serve.transform import VALID_COL as JAX_VALID_COL
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.kernels import (
    LAUNCHES,
    PAD_LAUNCH_SHAPES,
    _build,
    reset_launches,
)
from sntc_tpu_torch.kernels.assemble import (
    pad_assemble,
    pad_launch_shape,
    pad_rows,
    pad_rows_cuda,
    pad_rows_reference,
)
from sntc_tpu_torch.kernels.forest import (
    forest_leaf_stats,
    forest_leaf_stats_cuda,
    forest_leaf_stats_reference,
)
from sntc_tpu_torch.kernels.histogram import (
    level_histogram,
    tree_hist,
    tree_hist_cuda,
    tree_hist_plan,
    tree_hist_reference,
)
from sntc_tpu_torch.serve.transform import VALID_COL

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_forest(rng, T, max_depth, F, S, dtype=np.float32, p_split=0.7):
    """A structurally valid random dense-heap forest: internal nodes carry
    a feature/threshold, leaves carry stats, absent slots are -2; a node
    above ``max_depth`` splits with probability ``p_split``."""
    M = 2 ** (max_depth + 1) - 1
    feat = np.full((T, M), -2, np.int32)
    thr = np.zeros((T, M), dtype)
    leaf = np.zeros((T, M, S), dtype)

    def build(t, node, depth):
        if depth < max_depth and rng.random() < p_split:
            feat[t, node] = rng.integers(0, F)
            thr[t, node] = rng.normal()
            build(t, 2 * node + 1, depth + 1)
            build(t, 2 * node + 2, depth + 1)
        else:
            feat[t, node] = -1
            leaf[t, node] = rng.random(S).astype(dtype)

    for t in range(T):
        build(t, 0, 0)
    return feat, thr, leaf


def _features(rng, N, F, dtype, nan_fraction=0.0):
    X = rng.normal(size=(N, F)).astype(dtype)
    if nan_fraction:
        X[rng.random((N, F)) < nan_fraction] = np.nan
    return X


def _jax_twin(X, feat, thr, leaf, max_depth):
    # NaN features are part of the contract: the JAX debug-NaN guard
    # would stop at the first gathered NaN
    with jax.debug_nans(False):
        return np.asarray(
            jax_forest(
                jnp.asarray(X), jnp.asarray(feat), jnp.asarray(thr),
                jnp.asarray(leaf), max_depth=max_depth,
            )
        )


def _port(X, feat, thr, leaf, max_depth):
    return forest_leaf_stats(
        torch.from_numpy(X), torch.from_numpy(feat), torch.from_numpy(thr),
        torch.from_numpy(leaf), max_depth=max_depth,
    ).numpy()


FOREST_CASES = [
    # T, N, F, S, max_depth, NaN fraction
    (1, 5, 3, 2, 2, 0.0),
    (3, 17, 7, 3, 4, 0.1),
    (2, 128, 4, 5, 3, 0.0),
    (4, 130, 6, 2, 5, 0.05),
    (3, 333, 9, 15, 6, 0.02),
    # one stat (the GBT/DT heads' shape), an unaligned row count, and a
    # forest deeper than the CUDA kernel stages in shared memory
    (2, 33, 5, 1, 4, 0.1),
    (1, 33, 8, 16, 7, 0.0),
    (3, 40, 6, 3, 12, 0.05),
]


@pytest.mark.parametrize("T,N,F,S,max_depth,nan", FOREST_CASES)
def test_forest_reference_matches_jax_twin_f32(T, N, F, S, max_depth, nan):
    rng = np.random.default_rng(T * 1000 + N)
    feat, thr, leaf = _random_forest(rng, T, max_depth, F, S)
    X = _features(rng, N, F, np.float32, nan)
    out = _port(X, feat, thr, leaf, max_depth)
    assert out.dtype == np.float32 and out.shape == (T, N, S)
    np.testing.assert_array_equal(out, _jax_twin(X, feat, thr, leaf, max_depth))


@pytest.mark.parametrize("T,N,F,S,max_depth,nan",
                         FOREST_CASES[1:4] + FOREST_CASES[5:])
def test_forest_reference_matches_pallas_interpret_f32(
    T, N, F, S, max_depth, nan
):
    rng = np.random.default_rng(T * 7 + N)
    feat, thr, leaf = _random_forest(rng, T, max_depth, F, S)
    X = _features(rng, N, F, np.float32, nan)
    with jax.debug_nans(False):
        ref = np.asarray(
            forest_leaf_stats_pallas(
                jnp.asarray(X), jnp.asarray(feat), jnp.asarray(thr),
                jnp.asarray(leaf), max_depth=max_depth, interpret=True,
            )
        )
    np.testing.assert_array_equal(_port(X, feat, thr, leaf, max_depth), ref)


@pytest.mark.parametrize("nan", [0.0, 0.1])
def test_forest_reference_matches_jax_twin_f64_bitwise(nan):
    rng = np.random.default_rng(7)
    feat, thr, leaf = _random_forest(rng, 3, 4, 5, 3, np.float64)
    X = _features(rng, 23, 5, np.float64, nan)
    with jax.enable_x64(True):
        ref = _jax_twin(X, feat, thr, leaf, 4)
    assert ref.dtype == np.float64
    out = _port(X, feat, thr, leaf, 4)
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, ref)


def test_forest_nan_goes_left_and_walk_stops_at_leaves():
    # one tree: root splits on feature 0 at 0.5; left child splits on
    # feature 1 at 0.0, right child is a leaf; depth-2 heap
    feat = np.array([[0, 1, -1, -1, -1, -2, -2]], np.int32)
    thr = np.array([[0.5, 0.0, 0, 0, 0, 0, 0]], np.float32)
    leaf = np.arange(7, dtype=np.float32).reshape(1, 7, 1)
    X = np.array([[np.nan, 1.0], [1.0, np.nan], [0.0, np.nan],
                  [0.0, 2.0]], np.float32)
    out = _port(X, feat, thr, leaf, 2)[0, :, 0]
    # NaN at the root goes left, then x1=1.0 >= 0 goes right (node 4);
    # 1.0 >= 0.5 reaches the right leaf (node 2) and stops;
    # NaN at the second level goes left (node 3)
    np.testing.assert_array_equal(out, [4.0, 2.0, 3.0, 4.0])


def test_forest_dispatch_on_cpu_is_the_plain_version_without_launches():
    rng = np.random.default_rng(11)
    feat, thr, leaf = _random_forest(rng, 2, 3, 4, 3)
    X = torch.from_numpy(_features(rng, 40, 4, np.float32))
    args = (X, torch.from_numpy(feat), torch.from_numpy(thr),
            torch.from_numpy(leaf))
    before = dict(LAUNCHES)
    out = forest_leaf_stats(*args, max_depth=3)
    assert torch.equal(out, forest_leaf_stats_reference(*args, max_depth=3))
    assert LAUNCHES == before


def test_forest_wrappers_refuse_bad_inputs():
    rng = np.random.default_rng(12)
    feat, thr, leaf = _random_forest(rng, 2, 3, 4, 3)
    X = torch.from_numpy(_features(rng, 8, 4, np.float32))
    f, t, l = (torch.from_numpy(a) for a in (feat, thr, leaf))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        forest_leaf_stats_cuda(X, f, t, l, max_depth=3)
    with pytest.raises(TypeError, match="share one dtype"):
        forest_leaf_stats(X.double(), f, t, l, max_depth=3)
    with pytest.raises(TypeError, match="int32"):
        forest_leaf_stats(X, f.long(), t, l, max_depth=3)
    with pytest.raises(ValueError, match="heap slots"):
        forest_leaf_stats(X, f, t, l, max_depth=4)


PAD_CASES = [(5, 3, 8), (6, 1, 16), (130, 4, 256)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,c,target", PAD_CASES)
def test_pad_reference_matches_jax_pallas_and_numpy_twin(n, c, target, dtype):
    rng = np.random.default_rng(n * 31 + c)
    a = rng.normal(size=(n, c)).astype(dtype)
    out = pad_rows(torch.from_numpy(a), target).numpy()
    assert out.dtype == dtype
    np.testing.assert_array_equal(out, _pad_column_np(a, target))
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(
            pad_rows_pallas(jnp.asarray(a), target=target, interpret=True)
        )
    assert ref.dtype == dtype
    np.testing.assert_array_equal(out, ref)


def test_pad_plain_version_counts_no_launch():
    """The CPU's plain version is no launch: neither count moves.  A
    launch's shape key names the block, its dtype and the target."""
    reset_launches()
    pad_rows(torch.ones((3, 2)), 8)
    pad_rows(torch.ones((8, 2), dtype=torch.float64), 8)
    assert LAUNCHES["pad_assemble"] == 0 and PAD_LAUNCH_SHAPES == {}
    assert pad_launch_shape(60000, 78, torch.float32, 65536) \
        == "[60000, 78] f32 -> 65536"
    assert pad_launch_shape(1000, 78, torch.float64, 1024) \
        == "[1000, 78] f64 -> 1024"


def test_pad_wrappers_refuse_bad_inputs():
    a = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        pad_rows_cuda(a, 8)
    with pytest.raises(ValueError, match="pad target"):
        pad_rows(a, 2)
    with pytest.raises(TypeError, match="float32 or float64"):
        pad_rows(a.int(), 8)
    with pytest.raises(ValueError, match="empty block"):
        pad_rows(a[:0], 8)


# column-major blocks: N = 1, a zero-row pad (target == N), C not a
# multiple of 4, and a CICIDS2017-wide block
PAD_COLUMN_MAJOR_CASES = [(1, 5, 8), (5, 3, 5), (33, 13, 64), (130, 78, 256),
                          (64, 78, 64)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,c,target", PAD_COLUMN_MAJOR_CASES)
def test_pad_column_major_matches_jax_pallas_and_numpy_twin(n, c, target,
                                                            dtype):
    """``pad_rows`` on the transpose of a contiguous ``[C, N]`` block (the
    layout ``pad_assemble`` uploads) returns a contiguous row-major
    block, bitwise the JAX kernel's and the numpy twin's."""
    rng = np.random.default_rng(n * 17 + c)
    a = rng.normal(size=(n, c)).astype(dtype)
    block = torch.from_numpy(np.ascontiguousarray(a.T)).t()
    assert not block.is_contiguous() or min(n, c) == 1
    out = pad_rows(block, target)
    assert out.is_contiguous() and out.shape == (target, c)
    out = out.numpy()
    assert out.dtype == dtype
    np.testing.assert_array_equal(out, _pad_column_np(a, target))
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(
            pad_rows_pallas(jnp.asarray(a), target=target, interpret=True)
        )
    np.testing.assert_array_equal(out, ref)


def test_pad_wrappers_refuse_other_strides():
    """Only a row-major or a column-major block is taken; every other
    stride pattern is refused by the dispatch, the plain version and the
    kernel's wrapper alike (before the wrapper's device check)."""
    base = torch.arange(48, dtype=torch.float32).reshape(6, 8)
    for bad in (base[::2], base[:, ::2], base.t()[::2],
                torch.as_strided(base, (3, 4), (4, 2))):
        for fn in (pad_rows, pad_rows_reference, pad_rows_cuda):
            with pytest.raises(ValueError, match="row-major or a column-major"):
                fn(bad, 8)
    assert torch.equal(pad_rows(base.t().contiguous().t(), 8),
                       pad_rows(base, 8))


def test_pad_assemble_matches_jax_frame_twin_all_dtypes(monkeypatch):
    """Every numeric column dtype (float64, int64, float32, int32), a 2-D
    float column and a text column pad as the JAX package's
    ``Frame.pad_rows``; the 1-D columns of one item size reach
    ``pad_rows`` as one column-major block, the 2-D column as a
    row-major one."""
    import sntc_tpu_torch.kernels.assemble as assemble

    rng = np.random.default_rng(4)
    cols = {
        "x": rng.normal(size=(5, 4)).astype(np.float32),
        "a": rng.normal(size=5).astype(np.float32),
        "y": rng.normal(size=5),
        "b": rng.normal(size=5),
        "i": np.arange(5),
        "j": np.arange(5, dtype=np.int32) - 2,
        "s": np.array(list("abcde"), dtype=object),
    }
    valid = np.zeros(8, bool)
    valid[:5] = True
    seen = []

    def spy(a, target):
        seen.append((tuple(a.shape), a.dtype, a.is_contiguous()))
        return pad_rows(a, target)

    monkeypatch.setattr(assemble, "pad_rows", spy)
    before = dict(LAUNCHES)
    out = pad_assemble(Frame(cols), 8, valid, "cpu")
    assert LAUNCHES == before
    assert sorted(seen, key=str) == sorted([
        ((5, 4), torch.float32, True),     # the 2-D column, row-major
        ((5, 2), torch.float32, False),    # a, j: column-major
        ((5, 3), torch.float64, False),    # y, b, i: column-major
    ], key=str)
    ref = JFrame(cols).pad_rows(8).with_column(JAX_VALID_COL, valid)
    assert VALID_COL == JAX_VALID_COL
    assert out.columns == ref.columns
    for c in ref.columns:
        got = to_host(out[c])
        np.testing.assert_array_equal(got, np.asarray(ref[c]))
        assert got.dtype == ref[c].dtype
    # the columns of one item size share one padded row-major block on
    # the device
    assert isinstance(out["a"], torch.Tensor) and isinstance(out["b"], torch.Tensor)
    assert out["y"]._base is out["b"]._base

    def storage(c):
        return out[c].untyped_storage().data_ptr()

    assert storage("y") == storage("b") == storage("i")
    assert storage("a") == storage("j") != storage("y")
    assert out["a"].stride() == (2,) and out["y"].stride() == (3,)


def test_pad_assemble_splits_a_group_wider_than_the_kernel_takes(
        monkeypatch):
    """A group of columns wider than ``MAX_COLUMNS`` pads as several
    blocks of at most that width, each column still equal to the JAX
    package's ``Frame.pad_rows``."""
    import sntc_tpu_torch.kernels.assemble as assemble

    rng = np.random.default_rng(5)
    cols = {f"c{j}": rng.normal(size=3) for j in range(5)}
    seen = []

    def spy(a, target):
        seen.append(tuple(a.shape))
        return pad_rows(a, target)

    monkeypatch.setattr(assemble, "MAX_COLUMNS", 2)
    monkeypatch.setattr(assemble, "pad_rows", spy)
    valid = np.arange(4) < 3
    out = pad_assemble(Frame(cols), 4, valid, "cpu")
    assert seen == [(3, 2), (3, 2), (3, 1)]
    ref = JFrame(cols).pad_rows(4)
    for c in cols:
        np.testing.assert_array_equal(to_host(out[c]), np.asarray(ref[c]))


# -- tree_hist ---------------------------------------------------------------

# the cases of tests/test_pallas_histogram.py, plus GBT's shape (128 bins,
# [w, wy, wy²]-like signed fractional stats), a deep level's proportions
# (128 nodes × 32 bins × 15 stats: the CUDA kernel's rows regime) and a
# fit-like skew (one node holds 90 % of the rows, the upper half of the
# nodes is empty)
HIST_CASES = [
    # n, f, s, n_nodes, n_bins, skewed node ids
    pytest.param(300, 5, 3, 4, 8, False, id="300-5-3-4-8"),
    pytest.param(1000, 7, 15, 8, 32, False, id="1000-7-15-8-32"),
    pytest.param(64, 2, 1, 1, 32, False, id="64-2-1-1-32"),
    pytest.param(700, 4, 3, 4, 128, False, id="700-4-3-4-128"),
    pytest.param(2000, 3, 15, 128, 32, False, id="2000-3-15-128-32"),
    pytest.param(3000, 3, 15, 64, 32, True, id="skewed-3000-3-15-64-32"),
]
HIST_TOL = 1e-5  # the Pallas kernel's stated tolerance (f32 sums reordered)


def _skewed_nodes(rng, shape, n_nodes):
    """Node ids as a deep level of a fit has them: 90 % of the rows in
    one node, the rest spread over the lower half of the ids or inactive
    (-1), the upper half of the nodes empty."""
    hot = n_nodes // 3
    spread = rng.integers(-1, max(1, n_nodes // 2), size=shape)
    return np.where(rng.random(shape) < 0.9, hot, spread).astype(np.int32)


def _hist_inputs(rng, n, f, s, n_nodes, n_bins, skewed=False):
    binned = rng.integers(0, n_bins, size=(n, f)).astype(np.int32)
    if skewed:
        node_idx = _skewed_nodes(rng, n, n_nodes)
    else:
        node_idx = rng.integers(-1, n_nodes, size=n).astype(np.int32)
    stats = rng.normal(size=(n, s)).astype(np.float32)
    stats[node_idx < 0] = 0.0  # pre-masked, as the grower guarantees
    return binned, node_idx, stats


def _pallas_hist(binned, node_idx, stats, n_nodes, n_bins):
    return np.asarray(level_histogram_pallas(
        jnp.asarray(binned.T.copy()), jnp.asarray(node_idx),
        jnp.asarray(stats), n_nodes=n_nodes, n_bins=n_bins, interpret=True,
    ))


def _port_hist(binned, node_idx, stats, n_nodes, n_bins):
    return level_histogram(
        torch.from_numpy(binned.T.copy()), torch.from_numpy(node_idx),
        torch.from_numpy(stats), n_nodes=n_nodes, n_bins=n_bins,
    ).numpy()


@pytest.mark.parametrize("n,f,s,n_nodes,n_bins,skewed", HIST_CASES)
def test_tree_hist_reference_matches_pallas_interpret(n, f, s, n_nodes, n_bins,
                                                      skewed):
    rng = np.random.default_rng(n + f)
    args = _hist_inputs(rng, n, f, s, n_nodes, n_bins, skewed)
    got = _port_hist(*args, n_nodes, n_bins)
    assert got.shape == (f, n_nodes * n_bins, s) and got.dtype == np.float32
    np.testing.assert_allclose(got, _pallas_hist(*args, n_nodes, n_bins),
                               rtol=HIST_TOL, atol=HIST_TOL)


@pytest.mark.parametrize("n,f,s,n_nodes,n_bins,skewed", HIST_CASES)
def test_tree_hist_reference_bitwise_on_integer_stats(n, f, s, n_nodes, n_bins,
                                                      skewed):
    # one-hot classes × Poisson bagging counts: small-integer sums, exact
    # in any order
    rng = np.random.default_rng(n * 3 + s)
    binned, node_idx, _ = _hist_inputs(rng, n, f, s, n_nodes, n_bins, skewed)
    stats = np.eye(s, dtype=np.float32)[rng.integers(0, s, n)]
    stats *= rng.poisson(1.0, n).astype(np.float32)[:, None]
    stats[node_idx < 0] = 0.0
    np.testing.assert_array_equal(
        _port_hist(binned, node_idx, stats, n_nodes, n_bins),
        _pallas_hist(binned, node_idx, stats, n_nodes, n_bins),
    )


@pytest.mark.parametrize("fractional", [False, True])
def test_tree_hist_trees_in_one_call_equal_the_single_tree_function(fractional):
    # the grower's form — [T, N] node ids and weights, shared stats, the
    # weighting applied inside — is per tree the JAX single-tree function
    # on stats pre-weighted as the JAX grower weights them
    rng = np.random.default_rng(8)
    T, n, f, s, n_nodes, n_bins = 4, 500, 6, 5, 8, 16
    binned = rng.integers(0, n_bins, size=(n, f)).astype(np.int32)
    node = rng.integers(-1, n_nodes, size=(T, n)).astype(np.int32)
    if fractional:
        stats = rng.normal(size=(n, s)).astype(np.float32)
        w = rng.random((T, n)).astype(np.float32)
        w[rng.random((T, n)) < 0.3] = 0.0
    else:
        stats = np.eye(s, dtype=np.float32)[rng.integers(0, s, n)]
        w = rng.poisson(1.0, (T, n)).astype(np.float32)
    out = tree_hist(
        torch.from_numpy(binned.T.copy()), torch.from_numpy(node),
        torch.from_numpy(stats), torch.from_numpy(w),
        n_nodes=n_nodes, n_bins=n_bins,
    ).numpy()
    assert out.shape == (T, f, n_nodes * n_bins, s)
    for t in range(T):
        pre = stats * (w[t] * (node[t] >= 0))[:, None]
        single = _port_hist(binned, node[t], pre, n_nodes, n_bins)
        np.testing.assert_array_equal(out[t], single)
        ref = _pallas_hist(binned, node[t], pre, n_nodes, n_bins)
        if fractional:
            np.testing.assert_allclose(out[t], ref, rtol=HIST_TOL, atol=HIST_TOL)
        else:
            np.testing.assert_array_equal(out[t], ref)


# the one-vs-rest boosting fit's form: one row of stats per tree
# (tree t is class t's binary problem), [w, wr, wr²]-like signed
# fractional stats, 128 bins at the widest
PER_TREE_CASES = [
    # T, n, f, n_nodes, n_bins
    pytest.param(4, 600, 5, 1, 32, id="4-600-5-1-32"),
    pytest.param(3, 900, 4, 4, 128, id="3-900-4-4-128"),
    pytest.param(5, 1000, 3, 8, 16, id="5-1000-3-8-16"),
]


def _boosting_stats(rng, T, n, node):
    """Per-tree [w, w·r, w·r²] stats of signed pseudo-residuals r, zero
    where the tree's row is inactive (the grower's pre-masking)."""
    w = rng.random((T, n)).astype(np.float32)
    r = (2.0 * rng.normal(size=(T, n))).astype(np.float32)
    stats = np.stack([w, w * r, w * r * r], axis=-1).astype(np.float32)
    stats[node < 0] = 0.0
    return stats


@pytest.mark.parametrize("T,n,f,n_nodes,n_bins", PER_TREE_CASES)
def test_tree_hist_per_tree_reference_matches_pallas_interpret(
    T, n, f, n_nodes, n_bins
):
    """Per-tree stats ``[T, N, S]`` against the Pallas kernel in interpret
    mode mapped over the trees, as the JAX grower maps it: every cell
    within 1e-5 of its sum of absolute contributions (f32 sums in
    another order; the stats are signed, so a cell's own value can
    cancel to near zero)."""
    rng = np.random.default_rng(T * 100 + n_nodes)
    binned = rng.integers(0, n_bins, size=(n, f)).astype(np.int32)
    node = rng.integers(-1, n_nodes, size=(T, n)).astype(np.int32)
    stats = _boosting_stats(rng, T, n, node)
    kw = dict(n_nodes=n_nodes, n_bins=n_bins)
    args = (torch.from_numpy(binned.T.copy()), torch.from_numpy(node))
    out = tree_hist(*args, torch.from_numpy(stats), **kw).numpy()
    scale = tree_hist(*args, torch.from_numpy(np.abs(stats)), **kw).numpy()
    assert out.shape == (T, f, n_nodes * n_bins, 3)
    for t in range(T):
        ref = _pallas_hist(binned, node[t], stats[t], n_nodes, n_bins)
        assert (np.abs(out[t] - ref) <= HIST_TOL * scale[t]).all()
    # the layout of level_histogram_pallas: [T, N] node ids take
    # per-tree stats as they are
    np.testing.assert_array_equal(
        level_histogram(*args, torch.from_numpy(stats), **kw).numpy(), out)


@pytest.mark.parametrize("T,n,f,n_nodes,n_bins", PER_TREE_CASES)
def test_tree_hist_per_tree_equals_shared_form_on_equal_rows(
    T, n, f, n_nodes, n_bins
):
    """With every tree's stats row equal, the per-tree form computes the
    shared form: bitwise, on integer-valued stats and weights (sums
    exact in any order)."""
    rng = np.random.default_rng(T + n)
    binned_t = torch.from_numpy(
        rng.integers(0, n_bins, (f, n)).astype(np.int32))
    node = torch.from_numpy(
        rng.integers(-1, n_nodes, (T, n)).astype(np.int32))
    shared = torch.from_numpy(rng.integers(-3, 4, (n, 3)).astype(np.float32))
    w = torch.from_numpy(rng.poisson(1.0, (T, n)).astype(np.float32))
    kw = dict(n_nodes=n_nodes, n_bins=n_bins)
    per_tree = shared[None].expand(T, n, 3).contiguous()
    assert torch.equal(tree_hist(binned_t, node, per_tree, w, **kw),
                       tree_hist(binned_t, node, shared, w, **kw))


def test_tree_hist_refuses_per_tree_stats_of_another_tree_count():
    b = torch.zeros((3, 10), dtype=torch.int32)
    node = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="per-tree stats"):
        tree_hist(b, node, torch.ones((3, 10, 4)), n_nodes=1, n_bins=4)
    with pytest.raises(ValueError, match="row counts disagree"):
        tree_hist(b, node, torch.ones((2, 9, 4)), n_nodes=1, n_bins=4)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tree_hist_cuda(b, node, torch.ones((2, 10, 4)), n_nodes=1, n_bins=4)


def test_tree_hist_skips_ids_and_bins_out_of_range():
    binned_t = torch.tensor([[0, 1, 5, -1, 2]], dtype=torch.int32)  # B = 3
    node = torch.tensor([[0, 1, 0, 1, 2]], dtype=torch.int32)  # 2 nodes
    stats = torch.ones((5, 1))
    out = tree_hist(binned_t, node, stats, n_nodes=2, n_bins=3)[0, 0, :, 0]
    # row 2's bin 5 and row 3's bin -1 are outside [0, 3); row 4's node 2
    # is outside [0, 2): none of them lands anywhere
    np.testing.assert_array_equal(out.numpy(), [1, 0, 0, 0, 1, 0])


def test_tree_hist_dispatch_on_cpu_is_the_plain_version_without_launches():
    rng = np.random.default_rng(9)
    binned, node_idx, stats = _hist_inputs(rng, 200, 3, 4, 2, 8)
    args = (torch.from_numpy(binned.T.copy()), torch.from_numpy(node_idx)[None],
            torch.from_numpy(stats))
    before = dict(LAUNCHES)
    out = tree_hist(*args, n_nodes=2, n_bins=8)
    assert torch.equal(out, tree_hist_reference(*args, n_nodes=2, n_bins=8))
    assert LAUNCHES == before


def test_tree_hist_wrappers_refuse_bad_inputs():
    b = torch.zeros((3, 10), dtype=torch.int32)
    node = torch.zeros((2, 10), dtype=torch.int32)
    st = torch.ones((10, 4))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tree_hist_cuda(b, node, st, n_nodes=1, n_bins=4)
    with pytest.raises(TypeError, match="int32"):
        tree_hist(b.long(), node, st, n_nodes=1, n_bins=4)
    with pytest.raises(TypeError, match="float32"):
        tree_hist(b, node, st.double(), n_nodes=1, n_bins=4)
    with pytest.raises(ValueError, match="row counts disagree"):
        tree_hist(b, node[:, :9], st, n_nodes=1, n_bins=4)
    with pytest.raises(ValueError, match="weights"):
        tree_hist(b, node, st, torch.ones((3, 10)), n_nodes=1, n_bins=4)
    with pytest.raises(ValueError, match=">= 1"):
        tree_hist(b, node, st, n_nodes=0, n_bins=4)


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        _build.library()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|sntc_tpu)\b(?!_torch)", re.M
)
#: the same import inside a string literal: code a subprocess runs
#: (``python -c "from sntc_tpu..."``) imports the JAX package all the same
_FORBIDDEN_IN_STRING = re.compile(
    r"(?:import|from)\s+(?:jax|jaxlib|sntc_tpu)\b(?!_torch)"
)
_STRING_TOKENS = {tokenize.STRING, getattr(tokenize, "FSTRING_MIDDLE", -1)}


def _import_offenders(src):
    found = [m.group(0).strip() for m in _FORBIDDEN.finditer(src)]
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type in _STRING_TOKENS:
            found += [m.group(0) for m in
                      _FORBIDDEN_IN_STRING.finditer(tok.string)]
    return found


def test_port_imports_neither_jax_nor_the_jax_package():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "sntc_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    offenders = []
    for p in paths:
        with open(p) as f:
            src = f.read()
        offenders += [f"{os.path.relpath(p, REPO)}: {hit}"
                      for hit in _import_offenders(src)]
        # a dynamic import would dodge the pattern above
        assert "import_module(" not in src, p
    assert not offenders, offenders


def test_hygiene_pattern_catches_what_it_must():
    bad = ["import jax", "from jax import numpy", "import jax.numpy as jnp",
           "  from sntc_tpu.core.frame import Frame", "import sntc_tpu"]
    good = ["from sntc_tpu_torch.core import Frame", "import torch",
            "# import jax in a comment", "x = 'sntc_tpu.core.base.PipelineModel'"]
    assert all(_FORBIDDEN.search(s) for s in bad)
    assert not any(_FORBIDDEN.search(s) for s in good)
    # in a string literal, as a subprocess's code would carry it
    bad_str = ['CODE = "import json; from sntc_tpu.resilience import x"\n',
               "run(['-c', f'import jax; print({n})'])\n"]
    good_str = ['NOTE = "the JAX package\'s promote_standby"\n',
                "x = 'sntc_tpu.core.base.PipelineModel'\n",
                'CODE = "from sntc_tpu_torch.serve import fleet"\n']
    assert all(_import_offenders(s) for s in bad_str)
    assert not any(_import_offenders(s) for s in good_str)


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("T,N,F,S,max_depth,p_split", [
    (5, 1, 9, 15, 6, 0.7),
    (5, 1000, 9, 15, 6, 0.7),
    (5, 4097, 9, 15, 6, 0.7),
    # ragged and unaligned output runs (N*S not a multiple of 4)
    (20, 31, 40, 15, 10, 0.9),
    (20, 33, 40, 3, 10, 0.9),
    (1, 33, 40, 1, 10, 0.9),
    # several trees a block (the largest serve batch), and one tree
    (20, 65536, 40, 15, 10, 0.9),
    (1, 65536, 40, 16, 10, 0.9),
    # the GBT/DT heads' stats
    (20, 4097, 40, 1, 5, 0.9),
    # deeper than the levels staged in shared memory
    (3, 4097, 40, 16, 13, 0.9),
    (20, 2048, 40, 3, 15, 0.85),
    # an X tile too wide for shared memory: X through the read-only path
    (2, 1000, 200, 15, 8, 0.9),
    # bench config 4's fused one-vs-rest serve forest: 15 classes × 10
    # rounds of depth-4 trees over the 78 raw features, [w, wr, wr²]
    (150, 4097, 78, 3, 4, 0.9),
])
def test_forest_kernel_matches_plain_version_on_card(
    cuda_device, T, N, F, S, max_depth, p_split, dtype
):
    rng = np.random.default_rng(N * 31 + T * 7 + max_depth)
    feat, thr, leaf = _random_forest(rng, T, max_depth, F, S, dtype, p_split)
    X = _features(rng, N, F, dtype, 0.05)
    args = [torch.from_numpy(a).to(cuda_device) for a in (X, feat, thr, leaf)]
    out = forest_leaf_stats_cuda(*args, max_depth=max_depth)
    ref = forest_leaf_stats_reference(*args, max_depth=max_depth)
    torch.cuda.synchronize()
    assert out.shape == (T, N, S)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", [-1, 0, 3])
def test_forest_kernel_walks_at_most_max_depth_levels_on_card(
    cuda_device, walk
):
    # a walk shorter than the forest (a negative one walks no level)
    rng = np.random.default_rng(11)
    feat, thr, leaf = _random_forest(rng, 4, 6, 9, 3, np.float32, 0.9)
    X = _features(rng, 300, 9, np.float32, 0.05)
    args = [torch.from_numpy(a).to(cuda_device) for a in (X, feat, thr, leaf)]
    out = forest_leaf_stats_cuda(*args, max_depth=walk)
    ref = forest_leaf_stats_reference(*args, max_depth=walk)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("T,n,f,s,n_nodes,n_bins,skewed", [
    # the chi-square contingency: the shared regime
    pytest.param(1, 20000, 78, 15, 1, 32, False, id="1-20000-78-15-1-32"),
    # a forest's root level
    pytest.param(20, 20000, 40, 15, 1, 32, False, id="20-20000-40-15-1-32"),
    # a deep node group: the rows regime
    pytest.param(20, 20000, 40, 15, 128, 32, False, id="20-20000-40-15-128-32"),
    pytest.param(3, 999, 5, 3, 4, 8, False, id="3-999-5-3-4-8"),
    # levels 7 and 8 of config 3's fit, with a fit's skew
    pytest.param(20, 50000, 40, 15, 64, 32, True,
                 id="skewed-20-50000-40-15-64-32"),
    pytest.param(20, 50000, 40, 15, 128, 32, True,
                 id="skewed-20-50000-40-15-128-32"),
    # more trees than a thread of the rows regime holds at once
    pytest.param(40, 20000, 8, 15, 128, 32, True,
                 id="skewed-40-20000-8-15-128-32"),
])
def test_tree_hist_kernel_bitwise_on_integer_stats_on_card(
    cuda_device, T, n, f, s, n_nodes, n_bins, skewed
):
    rng = np.random.default_rng(n + T)
    binned_t = torch.from_numpy(
        rng.integers(0, n_bins, (f, n)).astype(np.int32)).to(cuda_device)
    node = (_skewed_nodes(rng, (T, n), n_nodes) if skewed
            else rng.integers(-1, n_nodes, (T, n)).astype(np.int32))
    node = torch.from_numpy(node).to(cuda_device)
    stats = torch.from_numpy(
        np.eye(s, dtype=np.float32)[rng.integers(0, s, n)]).to(cuda_device)
    # Poisson(1) bagging counts: ~37 % of the weights are 0
    w = torch.from_numpy(
        rng.poisson(1.0, (T, n)).astype(np.float32)).to(cuda_device)
    kw = dict(n_nodes=n_nodes, n_bins=n_bins)
    out = tree_hist_cuda(binned_t, node, stats, w, **kw)
    again = tree_hist_cuda(binned_t, node, stats, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, tree_hist_reference(binned_t, node, stats, w, **kw))
    assert torch.equal(out, again)
    regime = tree_hist_plan(n, f, T, n_nodes, n_bins, s)["regime"]
    if n_nodes * n_bins * s * 4 > 96 * 1024:  # not one feature fits
        assert regime == "rows"
    if T == 1 and n_nodes == 1:
        assert regime == "shared"


@pytest.mark.cuda
def test_tree_hist_kernel_fractional_within_tolerance_on_card(cuda_device):
    # GBT's shape: 128 bins, signed fractional stats; the error bound is
    # relative to each cell's sum of absolute contributions
    rng = np.random.default_rng(3)
    n, f, s, n_nodes, n_bins = 20000, 78, 3, 16, 128
    binned_t = torch.from_numpy(
        rng.integers(0, n_bins, (f, n)).astype(np.int32)).to(cuda_device)
    node = torch.from_numpy(
        rng.integers(-1, n_nodes, (1, n)).astype(np.int32)).to(cuda_device)
    stats = torch.from_numpy(rng.normal(size=(n, s)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.random((1, n)).astype(np.float32)).to(cuda_device)
    kw = dict(n_nodes=n_nodes, n_bins=n_bins)
    out = tree_hist_cuda(binned_t, node, stats, w, **kw)
    ref = tree_hist_reference(binned_t, node, stats, w, **kw)
    scale = tree_hist_reference(binned_t, node, stats.abs(), w, **kw)
    torch.cuda.synchronize()
    assert bool(((out - ref).abs() <= HIST_TOL * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T,n_nodes", [(1, 128), (2, 64), (8, 32)])
def test_tree_hist_kernel_fractional_rows_regime_on_card(cuda_device, T, n_nodes):
    # GBT's shape (128 bins, S=3, signed fractional stats and weights) on
    # the rows regime: one tree whose feature histogram does not fit a
    # block, or trees whose shared-memory histograms would scan the rows
    # too often; each cell within HIST_TOL of its absolute sum
    rng = np.random.default_rng(T * n_nodes)
    n, f, s, n_bins = 30000, 20, 3, 128
    binned_t = torch.from_numpy(
        rng.integers(0, n_bins, (f, n)).astype(np.int32)).to(cuda_device)
    node = torch.from_numpy(
        _skewed_nodes(rng, (T, n), n_nodes)).to(cuda_device)
    stats = torch.from_numpy(rng.normal(size=(n, s)).astype(np.float32)).to(cuda_device)
    w = rng.random((T, n)).astype(np.float32)
    w[rng.random((T, n)) < 0.37] = 0.0
    w = torch.from_numpy(w).to(cuda_device)
    kw = dict(n_nodes=n_nodes, n_bins=n_bins)
    assert tree_hist_plan(n, f, T, n_nodes, n_bins, s)["regime"] == "rows"
    out = tree_hist_cuda(binned_t, node, stats, w, **kw)
    ref = tree_hist_reference(binned_t, node, stats, w, **kw)
    scale = tree_hist_reference(binned_t, node, stats.abs(), w, **kw)
    torch.cuda.synchronize()
    assert bool(((out - ref).abs() <= HIST_TOL * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T,n_nodes", [(15, 1), (15, 2), (15, 4), (15, 8),
                                       (20, 1), (20, 8)])
def test_tree_hist_kernel_per_tree_stats_on_card(cuda_device, T, n_nodes):
    """The one-vs-rest boosting fit's launches (bench config 4: 78
    features, 128 bins, [w, wr, wr²] per class): each cell within
    HIST_TOL of its sum of absolute contributions; with every tree's
    stats row equal and integer-valued, bitwise equal to the shared
    form.  Node ids are skewed as a deep level's are; the labels behind
    the residuals are 80 % one class, as CICIDS2017's benign flows."""
    rng = np.random.default_rng(T * 10 + n_nodes)
    n, f, n_bins = 30000, 78, 128
    binned_t = torch.from_numpy(
        rng.integers(0, n_bins, (f, n)).astype(np.int32)).to(cuda_device)
    node_np = (_skewed_nodes(rng, (T, n), n_nodes) if n_nodes > 2
               else rng.integers(-1, n_nodes, (T, n)).astype(np.int32))
    node = torch.from_numpy(node_np).to(cuda_device)
    label = np.where(rng.random(n) < 0.8, 0, rng.integers(1, T, n))
    y = np.where(label[None, :] == np.arange(T)[:, None], 1.0, -1.0)
    margin = 0.3 * rng.normal(size=(T, n))
    r = 2.0 * y / (1.0 + np.exp(2.0 * y * margin))
    stats_np = np.stack([np.ones_like(r), r, r * r], -1).astype(np.float32)
    stats_np[node_np < 0] = 0.0
    stats = torch.from_numpy(stats_np).to(cuda_device)
    w = torch.ones((T, n), device=cuda_device)
    kw = dict(n_nodes=n_nodes, n_bins=n_bins)
    out = tree_hist_cuda(binned_t, node, stats, w, **kw)
    ref = tree_hist_reference(binned_t, node, stats, w, **kw)
    scale = tree_hist_reference(binned_t, node, stats.abs(), w, **kw)
    torch.cuda.synchronize()
    assert bool(((out - ref).abs() <= HIST_TOL * scale).all())
    shared = torch.from_numpy(
        rng.integers(-3, 4, (n, 3)).astype(np.float32)).to(cuda_device)
    same = tree_hist_cuda(binned_t, node,
                          shared[None].expand(T, n, 3).contiguous(), w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(same, tree_hist_cuda(binned_t, node, shared, w, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,c,target", PAD_CASES + [(1, 78, 256), (4097, 78, 8192)])
def test_pad_kernel_matches_plain_version_on_card(cuda_device, n, c, target, dtype):
    a = torch.randn((n, c), dtype=dtype, device=cuda_device)
    out = pad_rows_cuda(a, target)
    torch.cuda.synchronize()
    assert torch.equal(out, pad_rows_reference(a, target))


@pytest.mark.cuda
@pytest.mark.parametrize("n,target", [(65536, 65536), (8, 8), (60000, 65536),
                                      (1, 1)])
def test_pad_kernel_admission_block_on_card(cuda_device, n, target):
    """Row admission's launches: the contract's float32 [N, 78] block, a
    full bucket padded by zero rows (``target == N``) and a partial one,
    bitwise equal to the plain version."""
    a = torch.randn((n, 78), dtype=torch.float32, device=cuda_device)
    out = pad_rows_cuda(a, target)
    torch.cuda.synchronize()
    assert out.shape == (target, 78) and out.dtype == torch.float32
    assert torch.equal(out, pad_rows_reference(a, target))
    if target == n:
        assert out.data_ptr() != a.data_ptr() and torch.equal(out, a)


@pytest.mark.cuda
def test_pad_kernel_counts_launches_by_shape(cuda_device):
    """Each launch adds one to ``LAUNCHES`` and one to its block's entry
    in ``PAD_LAUNCH_SHAPES``; ``reset_launches`` clears both."""
    reset_launches()
    for n, target, dtype in ((60000, 65536, torch.float32),
                             (60000, 65536, torch.float32),
                             (30000, 32768, torch.float32),
                             (65536, 65536, torch.float32),
                             (1000, 1024, torch.float64)):
        pad_rows_cuda(torch.ones((n, 78), dtype=dtype, device=cuda_device),
                      target)
    torch.cuda.synchronize()
    assert LAUNCHES["pad_assemble"] == 5
    assert PAD_LAUNCH_SHAPES == {"[60000, 78] f32 -> 65536": 2,
                                 "[30000, 78] f32 -> 32768": 1,
                                 "[65536, 78] f32 -> 65536": 1,
                                 "[1000, 78] f64 -> 1024": 1}
    reset_launches()
    assert LAUNCHES["pad_assemble"] == 0 and PAD_LAUNCH_SHAPES == {}


# phase 2 of chip_smoke.py: every block height the serve path pads, a
# zero-row pad at each, C = 78 and a C that is not a multiple of 4
PAD_CARD_SHAPES = [(n, c, t) for n in (1, 33, 1000, 4097, 50000, 60000, 65536)
                   for c in (78, 13)
                   for t in sorted({n, 1 << max(8, (n - 1).bit_length())})]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["row-major", "column-major"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,c,target", PAD_CARD_SHAPES)
def test_pad_kernel_both_layouts_on_card(cuda_device, n, c, target, dtype,
                                         layout):
    """Both layouts, bitwise the plain version, into a contiguous
    row-major block distinct from the input."""
    g = torch.Generator(device=cuda_device).manual_seed(n * 7 + c)
    a = torch.randn((n, c), dtype=dtype, device=cuda_device, generator=g)
    if layout == "column-major":
        a = a.t().contiguous().t()
    out = pad_rows_cuda(a, target)
    torch.cuda.synchronize()
    assert out.shape == (target, c) and out.is_contiguous()
    assert out.data_ptr() != a.data_ptr()
    assert torch.equal(out, pad_rows_reference(a, target))


@pytest.mark.cuda
def test_pad_kernel_unaligned_column_major_views_on_card(cuda_device):
    """A column-major block whose columns start off 16 bytes (an odd N),
    and blocks of either layout whose first element is off 16 bytes (a
    storage offset), take the element-wise loads, bitwise all the
    same."""
    flat = torch.randn(78 * 4097 + 1, dtype=torch.float32, device=cuda_device)
    for a in (flat[:78 * 4097].view(78, 4097).t(),
              flat[1:].view(78, 4097).t(),
              flat[1:1 + 78 * 999].view(999, 78),
              flat[2:2 + 78 * 1000].view(78, 1000).t()):
        for target in (a.shape[0], 4096 if a.shape[0] < 4096 else 8192):
            out = pad_rows_cuda(a, target)
            torch.cuda.synchronize()
            assert torch.equal(out, pad_rows_reference(a, target))


@pytest.mark.cuda
def test_pad_kernel_counts_column_major_launches_by_shape(cuda_device):
    """A column-major launch counts under the same key as a row-major
    one of its shape."""
    reset_launches()
    for n, target, dtype, layout in (
            (60000, 65536, torch.float32, "column-major"),
            (60000, 65536, torch.float32, "row-major"),
            (65536, 65536, torch.float32, "column-major"),
            (1000, 1024, torch.float64, "column-major")):
        a = torch.ones((n, 78), dtype=dtype, device=cuda_device)
        pad_rows_cuda(a.t().contiguous().t() if layout == "column-major"
                      else a, target)
    torch.cuda.synchronize()
    assert LAUNCHES["pad_assemble"] == 4
    assert PAD_LAUNCH_SHAPES == {"[60000, 78] f32 -> 65536": 2,
                                 "[65536, 78] f32 -> 65536": 1,
                                 "[1000, 78] f64 -> 1024": 1}
    reset_launches()


@pytest.mark.cuda
def test_pad_assemble_on_card_matches_cpu(cuda_device):
    """``pad_assemble`` on the card: one launch per item size, on the
    column-major block, every column bitwise the CPU's."""
    rng = np.random.default_rng(13)
    n = 1000
    cols = {
        "f": rng.normal(size=n), "i": rng.integers(-5, 5, n),
        "g": rng.normal(size=n).astype(np.float32),
        "k": rng.integers(-5, 5, n).astype(np.int32),
        "x": rng.normal(size=(n, 3)),
    }
    valid = np.zeros(1024, bool)
    valid[:n] = True
    reset_launches()
    got = pad_assemble(Frame(cols), 1024, valid, cuda_device)
    torch.cuda.synchronize()
    assert LAUNCHES["pad_assemble"] == 3
    assert PAD_LAUNCH_SHAPES == {"[1000, 2] f64 -> 1024": 1,
                                 "[1000, 2] f32 -> 1024": 1,
                                 "[1000, 3] f64 -> 1024": 1}
    ref = pad_assemble(Frame(cols), 1024, valid, "cpu")
    for c in cols:
        np.testing.assert_array_equal(to_host(got[c]), to_host(ref[c]))
    reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 4097, 60000])
def test_pad_assemble_columnar_float32_block_on_card(cuda_device, tmp_path,
                                                     n):
    """The columnar source's frame (float32 views over Arrow buffers,
    read-only, non-finite values kept) through ``pad_assemble`` on the
    card: one launch of the [n, 78] float32 block, every column bitwise
    the CPU's, and the float32 cast of the float64 frame's."""
    from sntc_tpu_torch.data import (
        CICIDS2017_FEATURES,
        generate_frame,
        load_csv,
        write_raw_csv,
    )
    from sntc_tpu_torch.data.pipeline import read_flows_columnar
    from sntc_tpu_torch.serve.transform import bucket_rows_for

    path = str(tmp_path / "flows.csv")
    write_raw_csv(generate_frame(n, seed=n).drop("Label"), path)
    frame = read_flows_columnar(path, handle_invalid=None)
    assert all(frame[c].dtype == np.float32 for c in CICIDS2017_FEATURES)
    # views over Arrow's buffers (a column with parse-time nulls is the
    # one materialized copy)
    assert any(not frame[c].flags.writeable for c in CICIDS2017_FEATURES)
    target = bucket_rows_for(n, 256)
    valid = np.zeros(target, bool)
    valid[:n] = True
    reset_launches()
    got = pad_assemble(frame, target, valid, cuda_device)
    torch.cuda.synchronize()
    assert PAD_LAUNCH_SHAPES == {pad_launch_shape(
        n, len(CICIDS2017_FEATURES), torch.float32, target): 1}
    ref = pad_assemble(frame, target, valid, "cpu")
    legacy = load_csv(path)
    for c in CICIDS2017_FEATURES:
        card = to_host(got[c])
        assert np.array_equal(card.view(np.uint32),
                              to_host(ref[c]).view(np.uint32)), c
        cast = np.asarray(legacy[c]).astype(np.float32)
        assert np.array_equal(card[:n].view(np.uint32), cast.view(np.uint32))
    reset_launches()


def _ladder_shapes():
    """Every padded shape the controller's bucket-floor ladder gives a
    batch of the stream phase 13 serves, below and above the floors."""
    from sntc_tpu_torch.serve.controller import SHAPE_BUCKET_FLOORS
    from sntc_tpu_torch.serve.transform import bucket_rows_for

    shapes = set()
    for n in (40, 100, 300, 1000, 7000, 30000):
        for floor in SHAPE_BUCKET_FLOORS[1:] + (256,):
            target = bucket_rows_for(n, floor)
            if target != n:
                shapes.add((n, target))
    return sorted(shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,target", _ladder_shapes())
def test_pad_kernel_ladder_bucket_shapes_on_card(cuda_device, n, target,
                                                 dtype):
    """``pad_rows`` at each bucket the shape-bucket ladder reaches, in the
    column-major layout the serve path launches, bitwise the plain
    version and counted under its shape."""
    g = torch.Generator(device=cuda_device).manual_seed(n + target)
    a = torch.randn((78, n), dtype=dtype, device=cuda_device,
                    generator=g).t()
    reset_launches()
    out = pad_rows_cuda(a, target)
    torch.cuda.synchronize()
    assert torch.equal(out, pad_rows_reference(a, target))
    assert PAD_LAUNCH_SHAPES == {pad_launch_shape(n, 78, dtype, target): 1}
    reset_launches()
