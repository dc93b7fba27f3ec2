"""The ranks of a cell on several cards: one process a card, rank 0 in the
process that prints the result.

`spawn` starts ranks 1..n-1 (multiprocessing's spawn context) before
rank 0 joins them; every rank runs the cell's driver, and the port's
`init_distributed` joins the process group from the rendezvous this
module puts in each rank's environment (a free port on localhost).
`join` waits for every rank it started and raises if one failed; a rank
fails also where JAX or the JAX package was loaded in it by the end of
its run (`run.forbidden_modules`), so that no result is printed.
"""

from __future__ import annotations

import multiprocessing
import os
import socket
import sys
import time
import traceback


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def environment(rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))


def _rank(rank: int, world: int, port: int, run, args: tuple, kwargs: dict) -> None:
    import torch

    from benchmark.run import forbidden_modules

    environment(rank, world, port)
    torch.set_num_threads(1)    # as rank 0's process (run.py)
    try:
        run(*args, **kwargs)
    except BaseException:
        traceback.print_exc()
        raise
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: rank {rank} loaded {', '.join(loaded)}", file=sys.stderr)
        sys.exit(2)


def spawn(world: int, run, *args, **kwargs) -> list:
    """Start ranks 1..world-1 running run(*args, **kwargs); set this
    process up as rank 0. -> the processes, for `join`."""
    port = free_port()
    context = multiprocessing.get_context("spawn")
    procs = [context.Process(target=_rank, args=(r, world, port, run, args, kwargs))
             for r in range(1, world)]
    for p in procs:
        p.start()
    environment(0, world, port)
    return procs


def join(procs: list, timeout: float = 300.0) -> None:
    """Wait for every rank (`timeout` seconds in all), kill what is left,
    and raise if one failed."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    stop(procs)
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"{len(failed)} rank(s) failed: exit codes {failed}")


def stop(procs: list) -> None:
    """Kill the ranks that still run, and wait until each has ended."""
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
