"""Helpers for the port's multi-process tests: a gloo group of spawned
processes on this host, with a deadline."""

import pickle
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from complexhyperbolickge_torch.cli.run import free_port


def _entry(rank, fn, world, port, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def spawn_group(fn, world: int, args, out_dir, timeout: float = 240.0) -> list:
    """fn(rank, world, *args) in `world` spawned processes joined in one
    gloo group; returns each rank's result (written to out_dir).  Kills the
    group and raises TimeoutError after `timeout` seconds; a rank's
    exception re-raises here."""
    ctx = mp.start_processes(_entry, args=(fn, world, free_port(), str(out_dir), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"process group of {world} did not finish in {timeout} s")
    return [pickle.loads((Path(out_dir) / f"rank{r}.pkl").read_bytes()) for r in range(world)]
