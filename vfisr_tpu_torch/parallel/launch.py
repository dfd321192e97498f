"""Start a process group of spawned ranks, run a function on each, and stop
them all, within a time limit.

    results = run(fn, world_size, *args, backend="gloo", device="cpu")

Each rank is a process of the ``spawn`` start method that initialises the
group through a ``FileStore`` in ``store_dir`` (a fresh temporary directory
by default: no TCP port to pick), calls ``fn(rank, world_size, *args)``,
destroys the group and sends the result back (pickled: return CPU tensors,
arrays or numbers). fn must be importable by its module path. On ``cuda`` rank r
takes card ``r % device_count`` (several ranks share one card under gloo);
on the CPU each rank takes one intra-op thread, since the ranks share the
host's cores. A rank that raises, dies or outlives ``timeout`` seconds
fails the run: the others are killed, and RuntimeError or TimeoutError
names the rank.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional


def _rank_main(fn: Callable, rank: int, world: int, init_file: str, backend: str, device: str,
               timeout: float, results, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        # pickled here: a tensor put on the queue as it is would travel as a
        # shared-memory handle that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise


def run(fn: Callable, world_size: int, *args, backend: str = "gloo", device: str = "cpu",
        timeout: float = 600.0, store_dir: Optional[str] = None) -> List:
    """fn(rank, world_size, *args) on world_size spawned ranks; the results
    in rank order."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_file = os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init_file, backend, device, timeout, results,
                                   args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        done, deadline = {}, time.monotonic() + timeout
        try:
            while len(done) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(done))} of "
                                       f"{world_size} did not finish in {timeout:.0f} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} of {world_size} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{out}")
                done[rank] = pickle.loads(out)  # bytes a rank of this run wrote
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [done[r] for r in range(world_size)]
