"""The port's mesh substrate (``sntc_tpu_torch/parallel``) against the
JAX package's (``sntc_tpu/parallel``).

The JAX side runs on tier-1's 8 virtual CPU devices; the port's side on
virtual CPU shards (one device named several times).  Tolerances:

* ``pad_rows``, ``shard_batch``'s layout, ``collective_wire_bytes``,
  ``payload_nbytes``, ``MESH_AXES``, the exported names and
  ``process_info``'s keys: equal;
* ``tree_aggregate`` on integer-valued rows: bitwise across mesh sizes
  1, 2, 4, 8 in float64 and float32 (the sums are exact), and bitwise
  the JAX aggregate under ``jax.enable_x64(True)``;
* on fractional float32 rows: ``rtol = atol = 1e-5`` across mesh sizes
  and against the JAX aggregate (``tests/test_mesh.py``'s tolerance);
* the resize and the OOM split: bitwise the unfaulted result.
"""

import numpy as np
import pytest
import torch

import sntc_tpu_torch.parallel as PP
import sntc_tpu_torch.resilience as R
from sntc_tpu_torch.obs.metrics import registry
from sntc_tpu_torch.parallel import (
    default_mesh,
    make_mesh,
    make_tree_aggregate,
    set_collective_domain,
    shard_batch,
)
from sntc_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    P,
    collective_wire_bytes,
    map_at,
    map_reduce_at,
    payload_nbytes,
    reduce_at,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

MESH_SIZES = (1, 2, 4, 8)
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_state():
    R.clear()
    R.clear_events()
    set_collective_domain(None)
    yield
    R.clear()
    R.clear_events()
    set_collective_domain(None)


def _mesh(n):
    return default_mesh(n, device="cpu")


def _get(name, **labels):
    return registry().get(name, **labels) or 0


def _moments(xs, w):
    xw = xs * w[:, None]
    return {"sum": xw.sum(0), "gram": xw.t() @ xs}


def _jax_moments(xs, w):
    xw = xs * w[:, None]
    return {"sum": xw.sum(axis=0), "gram": xw.T @ xs}


# -- names and units ----------------------------------------------------------


def test_exports_and_axes_match_the_jax_package():
    import sntc_tpu.parallel as JP
    from sntc_tpu.parallel import mesh as JM

    assert PP.__all__ == JP.__all__
    assert PP.MESH_AXES == JM.MESH_AXES
    assert (PP.DATA_AXIS, PP.MODEL_AXIS) == (JM.DATA_AXIS, JM.MODEL_AXIS)


@pytest.mark.parametrize("buckets", ["1", "0"])
def test_pad_rows_matches_jax_on_a_grid(monkeypatch, buckets):
    from sntc_tpu.parallel import pad_rows as jax_pad_rows

    monkeypatch.setenv("SNTC_SHAPE_BUCKETS", buckets)
    ns = list(range(0, 300)) + [511, 512, 513, 1000, 4095, 4097, 62_500,
                                199_800, 1 << 20, (1 << 20) + 3]
    for shards in (1, 2, 3, 4, 5, 8, 16):
        for n in ns:
            assert PP.pad_rows(n, shards) == jax_pad_rows(n, shards), (
                n, shards)


@pytest.mark.parametrize("size", MESH_SIZES)
def test_shard_batch_layout_matches_jax(size):
    from sntc_tpu.parallel import default_mesh as jax_mesh
    from sntc_tpu.parallel import shard_batch as jax_shard_batch

    rng = np.random.default_rng(size)
    x = rng.normal(size=(203, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=203).astype(np.int64)
    px, py, pw = shard_batch(_mesh(size), x, y)
    jx, jy, jw = jax_shard_batch(jax_mesh(size), x, y)
    assert px.shape == jx.shape and pw.shape == jw.shape
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    # one contiguous block a shard, equal in rows
    assert len(px.blocks) == size
    assert all(b.is_contiguous() and b.shape[0] == px.shape[0] // size
               for b in px.blocks)


def test_shard_batch_pads_with_row_zero_and_zero_weight():
    x = np.arange(10, dtype=np.float32).reshape(10, 1)
    xs, w = shard_batch(_mesh(8), x)
    assert xs.shape == (16, 1) and w.shape == (16,)
    np.testing.assert_array_equal(w.numpy(), [1] * 10 + [0] * 6)
    assert xs.numpy()[10:].tolist() == [[0.0]] * 6


def test_wire_bytes_payload_and_process_info_match_jax():
    from sntc_tpu.parallel import process_info as jax_info
    from sntc_tpu.parallel.mesh import collective_wire_bytes as jax_wire
    from sntc_tpu.parallel.mesh import payload_nbytes as jax_payload

    for n in (0, 1, 2, 3, 8, 64):
        for b in (0, 1, 1000, 123_457):
            assert collective_wire_bytes(n, b) == jax_wire(n, b)
    tree = {"a": np.zeros(4, np.float64), "b": (np.zeros((2, 3), np.float32),)}
    assert payload_nbytes(tree) == jax_payload(tree) == 56
    assert payload_nbytes({"a": torch.zeros(4, dtype=torch.float64)}) == 32
    info = PP.process_info()
    assert set(info) == set(jax_info())
    assert info["process_index"] == 0 and info["process_count"] == 1


def test_meshes_default_make_hybrid():
    m = _mesh(4)
    assert m.shape == {"data": 4} and m.data_devices() == [
        torch.device("cpu")] * 4
    assert _mesh(None).shape == {"data": 1}
    m2 = make_mesh(devices=["cpu"] * 8)
    assert m2.shape == {"data": 8, "model": 1}
    m3 = make_mesh(data=2, model=2, devices=["cpu"] * 4)
    assert m3.shape == {"data": 2, "model": 2}
    assert len(m3.data_devices()) == 2
    # one process: the hybrid mesh is make_mesh
    assert PP.hybrid_mesh(devices=["cpu"] * 4) == make_mesh(
        devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        make_mesh(data=3, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            default_mesh(2)
    sh = PP.data_sharding(m, 2)
    assert tuple(sh.spec) == ("data", None) and not sh.is_fully_replicated
    assert PP.replicated_sharding(m).is_fully_replicated


def test_map_at_reduce_at_and_sharded_jit():
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    m = _mesh(8)
    out = map_reduce_at(
        m, lambda xs: {"sum": xs.sum(0), "sq": (xs * xs).sum()},
        in_specs=(P(DATA_AXIS, None),))(x)
    np.testing.assert_array_equal(out["sum"].numpy(), x.sum(axis=0))
    assert float(out["sq"]) == float((x * x).sum())
    rows = map_at(m, lambda xs: xs * 2.0, in_specs=(P(DATA_AXIS, None),),
                  out_specs=P(DATA_AXIS, None))(x)
    np.testing.assert_array_equal(rows.numpy(), x * 2.0)
    parts = [torch.tensor([3.0, -1.0]), torch.tensor([1.0, 5.0])]
    assert reduce_at(parts, combine="min").tolist() == [1.0, -1.0]
    assert reduce_at(parts, combine="max").tolist() == [3.0, 5.0]
    assert reduce_at(parts).tolist() == [4.0, 4.0]

    def f(a):
        return a + 1

    assert PP.sharded_jit(f, in_shardings=None) is f


# -- tree_aggregate across mesh sizes and against JAX -----------------------


def _port_agg(size, x):
    m = _mesh(size)
    out = make_tree_aggregate(_moments, m)(*shard_batch(m, x))
    return {k: v.numpy() for k, v in out.items()}


def _jax_agg(size, x):
    from sntc_tpu.parallel import default_mesh as jax_mesh
    from sntc_tpu.parallel import make_tree_aggregate as jax_agg
    from sntc_tpu.parallel import shard_batch as jax_shard_batch

    m = jax_mesh(size)
    out = jax_agg(_jax_moments, m)(*jax_shard_batch(m, x))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tree_aggregate_bitwise_on_integer_rows_across_sizes(dtype):
    import jax

    rng = np.random.default_rng(7)
    x = rng.integers(-50, 50, size=(512, 6)).astype(dtype)
    results = {s: _port_agg(s, x) for s in MESH_SIZES}
    base = results[1]
    assert base["sum"].dtype == dtype
    np.testing.assert_array_equal(base["sum"], x.sum(axis=0))
    for s in MESH_SIZES[1:]:
        for k in base:
            np.testing.assert_array_equal(base[k], results[s][k], err_msg=k)
    with jax.enable_x64(True):
        for s in (1, 8):
            j = _jax_agg(s, x)
            for k in base:
                assert j[k].dtype == dtype
                np.testing.assert_array_equal(results[s][k], j[k])


def test_tree_aggregate_f32_within_tolerance_across_sizes_and_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(512, 6)).astype(np.float32)
    results = {s: _port_agg(s, x) for s in MESH_SIZES}
    for s in MESH_SIZES[1:]:
        for k in results[1]:
            np.testing.assert_allclose(results[1][k], results[s][k],
                                       rtol=F32_TOL, atol=F32_TOL)
    for s in (1, 8):
        j = _jax_agg(s, x)
        for k in j:
            np.testing.assert_allclose(results[s][k], j[k], rtol=F32_TOL,
                                       atol=F32_TOL)


def test_replicated_args_and_combine():
    m = _mesh(4)
    x = np.arange(40, dtype=np.float32).reshape(20, 2) - 7.0
    xs, w = shard_batch(m, x)
    agg = make_tree_aggregate(
        lambda a, wt, shift: (a - shift[None, :]).amin(0), m,
        replicated_args=(2,), combine="min")
    np.testing.assert_array_equal(
        agg(xs, w, torch.tensor([1.0, 2.0])).numpy(),
        (x - np.array([1.0, 2.0], np.float32)).min(0))


# -- survival: resize, OOM split, retries -----------------------------------


def _int_batch(n=512, d=6, seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(-20, 20, size=(n, d)).astype(np.float32)


def test_device_lost_resizes_8_to_4_bitwise_and_migrates_lazily():
    from sntc_tpu_torch.resilience.device import DeviceFaultDomain

    m8 = _mesh(8)
    x = _int_batch()
    baseline = make_tree_aggregate(_moments, m8)(*shard_batch(m8, x))
    dom = DeviceFaultDomain()
    set_collective_domain(dom)
    agg = make_tree_aggregate(_moments, m8)
    before = _get("sntc_collective_resizes_total")
    R.arm("collective.dispatch", kind="device_lost", times=1)
    out = agg(*shard_batch(m8, x))
    assert agg.mesh().shape[DATA_AXIS] == 4
    for k in ("sum", "gram"):
        assert torch.equal(out[k], baseline[k]), k
    assert _get("sntc_collective_resizes_total") == before + 1
    assert _get("sntc_collective_mesh_devices", axis=DATA_AXIS) == 4
    resizes = [r for r in dom.journal if r.get("decision") == "mesh_resize"]
    assert len(resizes) == 1
    assert (resizes[0]["from"], resizes[0]["to"]) == (8, 4)
    assert dom.faults.get("device_lost") == 1 and not dom.failed
    # a batch placed for the ORIGINAL mesh migrates onto the survivors
    out2 = agg(*shard_batch(m8, x))
    assert torch.equal(out2["sum"], baseline["sum"])
    assert torch.equal(out2["gram"], baseline["gram"])


def test_resize_disabled_and_one_shard_propagate(monkeypatch):
    x = _int_batch(n=64)
    agg1 = make_tree_aggregate(_moments, _mesh(1))
    R.arm("collective.dispatch", kind="device_lost", times=1)
    with pytest.raises(Exception, match="(?i)device|cuda"):
        agg1(*shard_batch(_mesh(1), x))
    monkeypatch.setenv("SNTC_MESH_RESIZE", "0")
    agg = make_tree_aggregate(_moments, _mesh(8))
    R.arm("collective.dispatch", kind="device_lost", times=1)
    with pytest.raises(Exception, match="(?i)device|cuda"):
        agg(*shard_batch(_mesh(8), x))
    assert agg.mesh().shape[DATA_AXIS] == 8


def test_device_oom_splits_and_sums_bitwise():
    from sntc_tpu_torch.resilience.device import DeviceFaultDomain

    m8 = _mesh(8)
    x = _int_batch(seed=13)
    baseline = make_tree_aggregate(_moments, m8)(*shard_batch(m8, x))
    dom = DeviceFaultDomain()
    set_collective_domain(dom)
    agg = make_tree_aggregate(_moments, m8)
    R.arm("collective.dispatch", kind="device_oom", times=1)
    out = agg(*shard_batch(m8, x))
    for k in ("sum", "gram"):
        assert torch.equal(out[k], baseline[k]), k
    assert dom.oom_splits == 1
    assert agg.mesh().shape[DATA_AXIS] == 8  # no resize on OOM


def test_retries_and_breaker(monkeypatch):
    x = _int_batch(n=64)
    m = _mesh(2)
    monkeypatch.setenv("SNTC_COLLECTIVE_RETRIES", "2")
    agg = make_tree_aggregate(_moments, m)
    R.arm("collective.dispatch", kind="exc", times=1)
    out = agg(*shard_batch(m, x))
    assert torch.equal(out["sum"], torch.from_numpy(x.sum(0)))
    monkeypatch.delenv("SNTC_COLLECTIVE_RETRIES")
    monkeypatch.setenv("SNTC_COLLECTIVE_BREAKER", "1")
    from sntc_tpu_torch.resilience.circuit import CircuitOpenError, reset_breakers

    reset_breakers()
    try:
        agg = make_tree_aggregate(_moments, m)
        R.arm("collective.dispatch", kind="exc", times=None)
        with pytest.raises(CircuitOpenError):
            for _ in range(20):
                try:
                    agg(*shard_batch(m, x))
                except CircuitOpenError:
                    raise
                except Exception:
                    pass
    finally:
        reset_breakers()


# -- the evidence plane -------------------------------------------------------


def test_placement_and_resize_land_in_the_transfer_ledger():
    from sntc_tpu_torch.utils.profiling import TransferLedger, ledger_scope

    led = TransferLedger()
    x = _int_batch(n=128, seed=17)
    agg = make_tree_aggregate(_moments, _mesh(8))
    with ledger_scope(led):
        args = shard_batch(_mesh(8), x)
        snap = led.snapshot()
        assert snap["uploads"] >= 2 and snap["upload_bytes"] >= x.nbytes
        assert snap["dispatches"] == 0
        placed = snap["upload_bytes"]
        R.arm("collective.dispatch", kind="device_lost", times=1)
        agg(*args)
    snap = led.snapshot()
    assert snap["upload_bytes"] > placed and snap["dispatches"] == 0


def test_collective_dispatch_metrics():
    x = np.ones((64, 3), np.float32)
    m = _mesh(8)
    d0 = _get("sntc_collective_dispatches_total", op="tree_aggregate",
              axis=DATA_AXIS)
    b0 = _get("sntc_collective_bytes_moved_total", op="tree_aggregate",
              axis=DATA_AXIS)
    agg = make_tree_aggregate(lambda xs, w: (xs * w[:, None]).sum(0), m)
    out = agg(*shard_batch(m, x))
    assert _get("sntc_collective_dispatches_total", op="tree_aggregate",
                axis=DATA_AXIS) == d0 + 1
    assert _get("sntc_collective_bytes_moved_total", op="tree_aggregate",
                axis=DATA_AXIS) == b0 + collective_wire_bytes(
                    8, out.numel() * 4)
    assert _get("sntc_collective_mesh_devices", axis=DATA_AXIS) == 8


def test_device_cache_reuses_a_live_arrays_blocks(monkeypatch):
    m = _mesh(4)
    x = np.random.default_rng(0).normal(size=(70_000, 4)).astype(np.float32)
    a, _ = shard_batch(m, x)
    b, _ = shard_batch(m, x)
    assert a is b
    monkeypatch.setenv("SNTC_DEVICE_CACHE_MB", "0")
    c, _ = shard_batch(m, x)
    assert c is not a
    np.testing.assert_array_equal(c.numpy()[:70_000], x)


def test_fit_device_and_fit_mesh_rules():
    from sntc_tpu_torch.parallel.collectives import fit_device, fit_mesh

    m = _mesh(4)
    assert fit_device(None, m) == torch.device("cpu")
    assert fit_device("cpu", m) == torch.device("cpu")
    assert fit_mesh(None) is None and fit_mesh(_mesh(1)) is None
    assert fit_mesh(m) is m
    with pytest.raises(ValueError, match="first local device"):
        fit_device("cuda", m)


def test_note_mesh_resize_matches_the_jax_domain():
    from sntc_tpu.resilience.device import DeviceFaultDomain as JDomain
    from sntc_tpu_torch.resilience.device import DeviceFaultDomain

    port, ref = DeviceFaultDomain(), JDomain(probe_async=False)
    for d in (port, ref):
        d.note_mesh_resize(old=8, new=4, axis="data",
                           site="collective.dispatch")
    strip = [{k: v for k, v in r.items() if k != "ts"}
             for r in (port.journal[-1], ref.journal[-1])]
    assert strip[0] == strip[1]
    assert port.faults == {"device_lost": 1} == dict(ref.faults)
    assert not port.failed
