"""Start the ranks of a tensor-parallel run: one process a rank.

    from repro_torch.distributed import launch
    results = launch.run(fn, 2, args=(cfg_name,))   # [fn's return, a rank]

``run`` starts ``nprocs`` processes with ``torch.multiprocessing``'s
``spawn`` method, joins them into one ``torch.distributed`` process group
through a ``file://`` store in a fresh temporary directory, calls
``fn(rank, world, *args)`` in each, and returns each rank's return value
(pickled through that directory) in rank order.  ``fn`` must be importable
by name from a module (spawn pickles it by reference).  A rank that raises
stops the others, and ``run`` raises with its traceback; ranks still
running after ``timeout_s`` are stopped and ``run`` raises
``TimeoutError`` (the same bound is the process group's timeout).

The backend is the caller's choice: ``gloo`` on the CPU, and on a one-card
machine too, where several ranks share the card (NCCL refuses two ranks on
one device); ``tp.probe_cuda_collectives`` finds which gloo collectives
stage CUDA tensors through host memory.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def max_ranks() -> int:
    """The most ranks this machine starts: one a CPU core."""
    return os.cpu_count() or 1


def run(fn, nprocs: int, *, args: tuple = (), backend: str = "gloo",
        timeout_s: float = 1800.0, threads: int | None = None) -> list:
    """Run ``fn(rank, world, *args)`` on ``nprocs`` ranks; returns their
    results in rank order.  ``threads`` sets each rank's intra-op thread
    count (default: torch's)."""
    nprocs = int(nprocs)
    if not 1 <= nprocs <= max_ranks():
        raise ValueError(f"{nprocs} ranks asked for; this machine starts "
                         f"1 to {max_ranks()} (one a CPU core)")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        ranks = mp.start_processes(
            _rank_main, args=(fn, nprocs, backend, tmp, args, timeout_s,
                              threads),
            nprocs=nprocs, start_method="spawn", join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ranks.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks still running after "
                                       f"{timeout_s} s")
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
        out = []
        for rank in range(nprocs):
            with open(os.path.join(tmp, f"rank_{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank, fn, world, backend, tmp, args, timeout_s, threads):
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank_{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
