"""Process groups: ``parallel.initialize`` / ``global_mesh`` with gloo on
the CPU, two rank processes against the one-process mesh of 2.

Each rank process joins a ``file://`` rendezvous under ``tmp_path`` with
the launcher's ``WORLD_SIZE``/``RANK`` set, builds ``global_mesh()``
(rank r is shard r) and runs StandardScaler's moments aggregate and a
KMeans fit; it writes its results for the test to read.  The test waits
60 s at most (its own timeout) and kills the ranks on the way out.

Held: the moments of integer-valued rows bitwise the one-process mesh of
2's (every partial sum is exact); the KMeans centers within 1e-5
relative (``tests/test_mesh.py``'s tolerance) and the predictions equal.
A one-rank group's aggregate is bitwise the mesh of 1's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60

RANK_CODE = r"""
import sys
import numpy as np
import torch
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.feature.standard_scaler import standardization_moments
from sntc_tpu_torch.models import KMeans
from sntc_tpu_torch.parallel import (global_mesh, initialize,
                                     make_tree_aggregate, process_info,
                                     shard_batch)

url, out = sys.argv[1], sys.argv[2]
torch.set_num_threads(1)
assert initialize(url, device="cpu")
mesh = global_mesh()
info = process_info()
rng = np.random.default_rng(7)
xi = rng.integers(-50, 50, size=(515, 6)).astype(np.float32)
xf = np.random.default_rng(0).normal(3.0, 2.0, size=(600, 4)).astype(np.float32)
xs, w = shard_batch(mesh, xi)
n, mean, var = standardization_moments(xs, w, xi[0], mesh)
raw = make_tree_aggregate(
    lambda a, wt: torch.cat([wt @ a, wt @ (a * a)]), mesh)(xs, w)
km = KMeans(device="cpu", mesh=mesh, k=3, seed=1).fit(Frame({"features": xf}))
np.savez(out, n=n, mean=mean, var=var, raw=raw.numpy(),
         centers=km.clusterCenters,
         pred=km.transform(Frame({"features": xf}))["prediction"],
         shards=np.array(mesh.shape["data"]),
         local=np.array(mesh.local_shards()),
         info=np.array([info["process_index"], info["process_count"]]))
torch.distributed.destroy_process_group()
"""


def _run_ranks(tmp_path, world):
    env = dict(os.environ)
    env.update(PYTHONPATH=REPO, WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               MASTER_ADDR="", MASTER_PORT="")
    url = f"file://{tmp_path}/rendezvous"
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_CODE, url,
                 str(tmp_path / f"rank{r}.npz")],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO))
        for p in procs:
            _out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _one_process(size):
    from sntc_tpu_torch.core.frame import Frame
    from sntc_tpu_torch.feature.standard_scaler import standardization_moments
    from sntc_tpu_torch.models import KMeans
    from sntc_tpu_torch.parallel import (default_mesh, make_tree_aggregate,
                                         shard_batch)

    mesh = default_mesh(size, device="cpu")
    xi = np.random.default_rng(7).integers(
        -50, 50, size=(515, 6)).astype(np.float32)
    xf = np.random.default_rng(0).normal(
        3.0, 2.0, size=(600, 4)).astype(np.float32)
    xs, w = shard_batch(mesh, xi)
    n, mean, var = standardization_moments(xs, w, xi[0], mesh)
    raw = make_tree_aggregate(
        lambda a, wt: torch.cat([wt @ a, wt @ (a * a)]), mesh)(xs, w)
    km = KMeans(device="cpu", mesh=mesh, k=3, seed=1).fit(
        Frame({"features": xf}))
    return dict(n=n, mean=mean, var=var, raw=raw.numpy(),
                centers=km.clusterCenters,
                pred=km.transform(Frame({"features": xf}))["prediction"])


def test_two_gloo_ranks_equal_the_one_process_mesh_of_2(tmp_path):
    ranks = _run_ranks(tmp_path, 2)
    ref = _one_process(2)
    for r, got in enumerate(ranks):
        assert int(got["shards"]) == 2 and got["local"].tolist() == [r]
        assert got["info"].tolist() == [r, 2]
        np.testing.assert_array_equal(got["raw"], ref["raw"])
        for k in ("n", "mean", "var"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        c = np.asarray(got["centers"], np.float64)
        assert np.abs(c - ref["centers"]).max() <= 1e-5 * np.abs(
            ref["centers"]).max()
        np.testing.assert_array_equal(got["pred"], ref["pred"])


def test_a_one_rank_group_equals_the_mesh_of_1(tmp_path):
    (got,) = _run_ranks(tmp_path, 1)
    ref = _one_process(1)
    assert int(got["shards"]) == 1
    np.testing.assert_array_equal(got["raw"], ref["raw"])
    for k in ("n", "mean", "var"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_initialize_without_a_launcher_is_a_no_op(monkeypatch):
    from sntc_tpu_torch.parallel import distributed as D

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    if torch.distributed.is_initialized():
        pytest.skip("a process group is already up in this process")
    assert D.initialize() is False
    assert not torch.distributed.is_initialized()


def test_nccl_without_a_card_raises(monkeypatch):
    from sntc_tpu_torch.parallel import distributed as D

    if torch.cuda.is_available() or torch.distributed.is_initialized():
        pytest.skip("needs a host without CUDA and no process group")
    with pytest.raises(RuntimeError, match="nccl"):
        D.initialize("file:///nonexistent", 1, 0, device="cpu",
                     backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        D.initialize("file:///nonexistent", 1, 0, device="cpu",
                     backend="mpi")
    assert not torch.distributed.is_initialized()
