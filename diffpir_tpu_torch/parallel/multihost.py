"""Multi-process bootstrap, input shards and the multi-process dry run.

Port of ``diffpir_tpu/parallel/multihost.py``.  In the JAX package a process
drives several devices and ``jax.distributed.initialize`` joins processes;
here a rank is one process on one device, and ``torch.distributed`` joins
them:

  * ``initialize``: ``init_process_group`` from an explicit address or from
    the environment ``torchrun`` sets; a no-op for one process, as in JAX.
    NCCL when every rank of the host has a card of its own, else gloo
    (NCCL refuses two ranks on one card);
  * ``process_shard_info``: (rank, world size) for input pipelines;
  * ``globalize_batch``: the ranks' local rows gathered into the global batch
    over the ``data`` axis (``Runner.restore_batch`` takes global batches);
  * ``fetch_global``: a data-sharded tensor gathered to host numpy;
  * ``spawn``: run a function on a new group of local ranks (gloo over
    ``tcp://127.0.0.1``), each in its own process, and collect what each
    returns;
  * ``dryrun_multiprocess(num_processes, devices_per_process)``: as the JAX
    package's, num_processes x devices_per_process ranks restore a batch
    from their own rows and take one sharded train step, and a one-rank
    reference does the same unsharded; ``restore_mean`` and ``train_loss``
    must agree within 5e-5.

    python -m diffpir_tpu_torch.parallel.multihost [NUM_PROCESSES [DEVICES_PER_PROCESS]]
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "process_shard_info", "globalize_batch", "fetch_global",
           "spawn", "free_port", "rank_device", "dryrun_multiprocess"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def rank_device(local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: the CPU without a card, else card
    ``local_rank % device_count`` (ranks share cards in turn)."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0)
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join this process to its group: ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id`` given, or (all None) the
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` that ``torchrun``
    sets.  A no-op for one process without an address, as in JAX (an
    explicit address with one process makes a group of one).  ``backend``
    defaults to NCCL when each local rank has a card of its own and to gloo
    otherwise; with a card, the rank's current device becomes
    ``rank_device()``."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if num_processes in (None, 1) and _env_int("WORLD_SIZE", 1) == 1:
            return
        num_processes = _env_int("WORLD_SIZE", 1)
        process_id = _env_int("RANK", 0)
        init = "env://"
    else:
        init = f"tcp://{coordinator_address}"
        num_processes = 1 if num_processes is None else num_processes
        process_id = 0 if process_id is None else process_id
    local_world = _env_int("LOCAL_WORLD_SIZE", num_processes)
    local_rank = _env_int("LOCAL_RANK", process_id)
    if backend is None:
        own_card = torch.cuda.is_available() and torch.cuda.device_count() >= local_world
        backend = "nccl" if own_card else "gloo"
    kw = {}
    if torch.cuda.is_available():
        dev = rank_device(local_rank)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, **kw)


def process_shard_info() -> tuple[int, int]:
    """(shard, num_shards) for input pipelines: (rank, world size), (0, 1)
    for one process."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def globalize_batch(local_batch, mesh, axis: str = "data"):
    """The global batch from each data rank's ``local_batch`` rows (leading
    dim = global batch / data ranks), in rank order; every rank gets all of
    it, as numpy when it was given numpy.  One rank, or no ``axis`` on the
    mesh: ``local_batch`` itself."""
    from diffpir_tpu_torch.parallel.collectives import all_gather

    if mesh is None or mesh.axis_size(axis) == 1:
        return local_batch
    is_np = isinstance(local_batch, np.ndarray)
    t = torch.as_tensor(local_batch)
    out = all_gather(t, mesh, axis, dim=0)
    return out.numpy() if is_np else out


def fetch_global(x, mesh=None, axis: str = "data") -> np.ndarray:
    """Host numpy of a tensor whose leading dim is sharded over ``axis``:
    every rank gets the full array.  Unsharded tensors take the plain
    fetch."""
    from diffpir_tpu_torch.parallel.collectives import all_gather

    if mesh is not None and mesh.axis_size(axis) > 1:
        x = all_gather(x, mesh, axis, dim=0)
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# local groups of ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(rank: int, world: int, port: int, target: str, args_json: str,
               threads: int) -> None:
    torch.set_num_threads(threads)
    if world > 1:
        initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        result = _resolve(target)(*json.loads(args_json))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print("RANK_RESULT " + json.dumps(result), flush=True)


def spawn(target: str, world: int, args: Sequence[Any] = (), *, threads: int = 2,
          timeout: float = 900.0, env: Optional[dict] = None) -> list:
    """Run ``module:function(*args)`` on ``world`` new local ranks joined over
    gloo (one process each, ``threads`` torch threads each) and return what
    each rank's call returned (JSON), in rank order.  Raises, with the
    failing rank's error output, when any rank fails or outlives
    ``timeout``; then every rank is stopped."""
    port = free_port()
    penv = dict(os.environ, **(env or {}))
    penv["OMP_NUM_THREADS"] = str(threads)
    penv["LOCAL_WORLD_SIZE"] = str(world)
    penv["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in penv.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    for r in range(world):
        penv_r = dict(penv, LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "diffpir_tpu_torch.parallel.multihost", "rank",
             str(r), str(world), str(port), target, json.dumps(list(args)),
             str(threads)],
            cwd=_REPO, env=penv_r, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs: list = [None] * world

    def reader(r: int) -> None:
        outs[r] = procs[r].communicate()

    readers = [threading.Thread(target=reader, args=(r,), daemon=True)
               for r in range(world)]
    for t in readers:
        t.start()
    failure = None
    deadline = time.monotonic() + timeout
    try:
        # a rank that fails leaves the others waiting in a collective: stop
        # them all at the first failure
        while failure is None and any(t.is_alive() for t in readers):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    readers[r].join()
                    failure = (f"rank {r} of {world} exited with {p.returncode}; "
                               f"stderr tail:\n{outs[r][1][-3000:]}")
                    break
            if failure is None and time.monotonic() > deadline:
                failure = f"ranks of a group of {world} outlived {timeout} s"
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in readers:
            t.join()
    if failure is not None:
        raise RuntimeError(failure)
    results = []
    for r, (out, err) in enumerate(outs):
        if procs[r].returncode != 0:
            raise RuntimeError(f"rank {r} of {world} exited with {procs[r].returncode}; "
                               f"stderr tail:\n{err[-3000:]}")
        lines = [ln for ln in out.splitlines() if ln.startswith("RANK_RESULT ")]
        if not lines:
            raise RuntimeError(f"rank {r} of {world} returned nothing; stdout tail:\n"
                               f"{out[-2000:]}")
        results.append(json.loads(lines[-1][len("RANK_RESULT "):]))
    return results


# ---------------------------------------------------------------------------
# the multi-process dry run (the JAX package's DCN cluster, as local ranks)
# ---------------------------------------------------------------------------

def _dryrun_worker(n_global: int) -> dict:
    """One rank (or, with no group, the reference): restore a global inpaint
    batch from this rank's own rows, then one train step."""
    from diffpir_tpu_torch.config import load_config
    from diffpir_tpu_torch.data import Batch
    from diffpir_tpu_torch.parallel.mesh import make_mesh
    from diffpir_tpu_torch.runner import Runner
    from diffpir_tpu_torch.train.loop import dryrun_train_step

    world = dist.get_world_size() if dist.is_initialized() else 1
    H = 32
    cfg = load_config(None, overrides=dict(
        task="inpaint", model_name="tiny_test", iter_num=2, iter_num_U=1,
        batch_size=n_global, noise_level_img=0.0, seed=0, dtype="float32",
        save_L=False, save_E=False,
        mesh_shape=(n_global,) if world > 1 else None))
    runner = Runner(cfg, device=rank_device(), use_mesh=True)
    # the deterministic GLOBAL batch; this rank keeps only its rows
    rng = np.random.default_rng(0)
    img_H = rng.integers(0, 256, (n_global, H, H, 3)).astype(np.uint8)
    mask = (rng.uniform(size=img_H.shape) > 0.5).astype(np.float32)
    img_L = img_H.astype(np.float32) * mask / 255.0
    shard, n_shards = process_shard_info()
    per = n_global // n_shards
    lo, hi = shard * per, (shard + 1) * per
    glob = lambda a: globalize_batch(a[lo:hi], runner.mesh)  # noqa: E731
    local = Batch(img_H=glob(img_H), img_L=glob(img_L),
                  kernel=glob(np.ones((n_global, 1, 1), np.float32)), mask=glob(mask),
                  names=[f"im{i}" for i in range(n_global)])
    out = runner.restore_batch(local)
    assert out.shape == img_H.shape, (out.shape, img_H.shape)
    loss = dryrun_train_step(world)
    return {"process": shard, "num_processes": n_shards,
            "restore_mean": float(np.mean(out)), "train_loss": float(loss)}


def dryrun_multiprocess(num_processes: int = 2, devices_per_process: int = 4,
                        timeout: float = 900.0) -> None:
    """Run the multi-process path for real: ``num_processes *
    devices_per_process`` ranks (one per device) restore one global batch
    assembled from their own rows and take one sharded train step; a
    one-rank reference runs the same unsharded.  Every rank must report the
    reference's ``restore_mean`` and ``train_loss`` within 5e-5."""
    n_global = num_processes * devices_per_process
    rows = spawn("diffpir_tpu_torch.parallel.multihost:_dryrun_worker", n_global,
                 [n_global], timeout=timeout)
    (ref,) = spawn("diffpir_tpu_torch.parallel.multihost:_dryrun_worker", 1,
                   [n_global], timeout=timeout)
    assert ref["num_processes"] == 1, ref
    for r in rows:
        assert r["num_processes"] == n_global, rows
        for key in ("restore_mean", "train_loss"):
            if abs(r[key] - ref[key]) > 5e-5:
                raise AssertionError(
                    f"{key} mismatch: rank {r['process']} of {n_global} got {r[key]}, "
                    f"the one-rank reference got {ref[key]}")
    print(f"dryrun_multiprocess({num_processes}x{devices_per_process}): OK "
          f"({n_global} ranks: restore + train step, parity with one rank)")


if __name__ == "__main__":
    if len(sys.argv) >= 8 and sys.argv[1] == "rank":
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                   sys.argv[6], int(sys.argv[7]))
    else:
        dryrun_multiprocess(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                            int(sys.argv[2]) if len(sys.argv) > 2 else 4)
