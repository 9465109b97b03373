"""Joining the world of ranks a launcher started.

``torchrun`` (or a test, or ``chip_smoke.py``'s spawner) starts one process
per rank; :func:`init_world` reads its place, picks the process group's
backend and this rank's device, and initialises the default group that
``ShardingPlan.make_mesh`` builds on.  The backend rule: ``nccl`` only when
every rank of the node has a GPU of its own, ``gloo`` otherwise (several
ranks on one GPU, or the CPU) — NCCL refuses two ranks on one device, and
``gloo`` takes CUDA tensors in ``all_reduce`` and ``broadcast``, which is all
the serving path's collectives need (point-to-point goes through host
tensors).  Nothing on the machine tells a program of a cluster: the
rendezvous address comes from the caller or torchrun's environment.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class World:
    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str


def pick_backend(device_type: str, local_world: int) -> str:
    """``nccl`` when each of the node's ``local_world`` ranks has a GPU of
    its own, else ``gloo``."""
    if device_type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_world(device_type: str = "cuda", *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None) -> World:
    """Initialise the default process group (once) and return this rank's
    :class:`World`.  Unset arguments come from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` through
    ``init_method="env://"``); ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    default to the rank and the world size (one node).  The device is
    ``cuda:{LOCAL_RANK % device_count}`` (ranks beyond the GPUs share them)
    or the CPU."""
    import datetime

    import torch.distributed as dist

    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    if device_type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = pick_backend(device_type, local_world)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world_size, timeout=datetime.timedelta(seconds=300))
    return World(rank, world_size, local_rank, device, backend)


def _rank_main(fn, rank, nprocs, init_method, args, out_path):
    import pickle

    result = fn(rank, nprocs, init_method, *args)
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def spawn_world(fn, nprocs: int, args=(), *,
                timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, nprocs, init_method, *args)`` in ``nprocs`` fresh
    processes (``spawn``) and return their results in rank order.
    ``init_method`` is a ``file://`` rendezvous in a temporary directory
    for :func:`init_world`.  The parent joins
    every rank within ``timeout_s`` in all; a rank that raises, exits non
    zero or runs past the limit fails the whole world: every rank still
    running is terminated and ``RuntimeError`` names the exit codes.
    ``fn`` must be importable by the children (a module-level function of
    an importable module, or of a ``__main__`` guarded by ``if __name__ ==
    "__main__"``); its result must pickle."""
    import multiprocessing
    import pickle
    import tempfile
    import time

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(nprocs)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nprocs, init, args, outs[r]))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            # poll every rank: one that fails leaves the others blocked in
            # a collective, so the first failure ends the wait
            while time.monotonic() < deadline:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes) or \
                        all(c == 0 for c in codes):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                        p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"a rank of the {nprocs}-rank world failed or "
                               f"ran past {timeout_s:.0f} s: exit codes "
                               f"{codes}")
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
