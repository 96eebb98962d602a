"""The port's multi-process layer (``parallel/multihost.py``): the in-process
helpers as ``tests/test_multihost.py:22-39`` holds the JAX package's, and the
multi-process dry run for real (two gloo ranks on the CPU, two threads
each, and a one-rank reference)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffpir_tpu_torch.parallel import multihost
from diffpir_tpu_torch.parallel.mesh import abstract_mesh, make_mesh


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize()  # must not raise or hang
    assert not dist.is_initialized()


def test_process_shard_info():
    assert multihost.process_shard_info() == (0, 1)


def test_globalize_batch_and_fetch_on_one_process():
    """One process: the local batch is the global one, and a fetch is the
    plain one (no group, no collective)."""
    mesh = make_mesh()
    batch = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    out = multihost.globalize_batch(batch, mesh)
    assert out is batch
    np.testing.assert_array_equal(multihost.fetch_global(torch.from_numpy(batch), mesh), batch)


def test_globalize_batch_records_the_gather_on_an_abstract_mesh():
    mesh = abstract_mesh((4,), ("data",))
    mesh.log = []
    out = multihost.globalize_batch(torch.empty((2, 3), device="meta"), mesh)
    assert out.shape == (8, 3)
    assert mesh.log == [("all_gather", "data", 2 * 3 * 4 * 3)]


def test_spawn_reports_the_failing_rank():
    # whichever rank the poll sees first: rank 1, or rank 0 whose peer is gone
    with pytest.raises(RuntimeError, match=r"rank [01] of 2 exited with"):
        multihost.spawn("tests.test_torch_multihost:_fail_on_rank_1", 2, timeout=120)


def _fail_on_rank_1():
    if dist.get_rank() == 1:
        raise SystemExit(3)
    t = torch.ones(1)
    dist.all_reduce(t)  # rank 0 fails or waits here until the group is stopped
    return float(t)


def test_two_rank_cluster_runs_the_multiprocess_path():
    """2 ranks x 1 device: each restores the global batch assembled from its
    own rows (globalize_batch) and takes one sharded train step; both match a
    one-rank run."""
    multihost.dryrun_multiprocess(num_processes=2, devices_per_process=1)
