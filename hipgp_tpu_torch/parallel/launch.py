"""Start a world of ranks on this machine and run one function in each.

The port's counterpart of the JAX package's single-process multi-device
execution (one process drives every device of a mesh there; here each
device has a process of its own).  :func:`run` starts ``n`` ranks with
``torch.multiprocessing``'s spawn method, joins them into one process group
(`multihost.initialize` on a free localhost port, with the given backend and
device), calls ``fn(*args, **kwargs)`` in each and returns what each
returned, in rank order.  If a rank raises, dies or outlives ``timeout_s``,
every rank is stopped and :func:`run` raises with that rank's traceback.

``fn`` must be a module-level function of a module the ranks can import,
and what it returns must pickle (move tensors to the CPU).  The drivers are
started by ``torchrun`` instead.
"""
from __future__ import annotations

import queue as _queue
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.multiprocessing as mp

from . import multihost

__all__ = ["run"]


def _rank_main(rank, n, port, backend, device, timeout_s, fn, args, kwargs, out):
    try:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        multihost.initialize(f"127.0.0.1:{port}", n, rank, backend=backend, device=dev,
                             timeout_s=timeout_s)
        out.put((rank, True, fn(*args, **(kwargs or {}))))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run(fn: Callable, n: int, *, backend: str = "gloo", device: str = "cuda",
        args=(), kwargs: Optional[dict] = None, timeout_s: float = 600.0) -> List:
    """Run ``fn(*args, **kwargs)`` in ``n`` ranks of one process group and
    return the ``n`` results in rank order.  ``device``: 'cuda' (the
    default: rank r on ``cuda:r % device_count``, so every rank on the one
    card of a one-card machine), a named CUDA device, or 'cpu';
    ``backend``: 'gloo' or 'nccl'.  Raises RuntimeError, every rank stopped, if one raises, exits
    early or the world outlives ``timeout_s``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = multihost.free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, backend, device, timeout_s, fn, args, kwargs,
                               out), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    results, failure = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < n and failure is None:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    # a last message may still be in flight
                    try:
                        rank, ok, value = out.get(timeout=5.0)
                    except _queue.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and sent no result")
                        break
                elif time.monotonic() > deadline:
                    failure = f"the world of {n} ranks outlived {timeout_s:.0f} s"
                    break
                else:
                    continue
            if ok:
                results[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.kill()
        for p in procs:
            p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"launch.run({getattr(fn, '__name__', fn)}): {failure}")
    return [results[r] for r in range(n)]
