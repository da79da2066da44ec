"""Run one function on N local ranks: a process group on one machine,
each rank a spawned process, for tests and smoke runs (a job across
machines starts its processes with torchrun and calls
``initialize_distributed`` itself).

Every rank must end by the deadline: a rank that raises ends the others
(``torch.multiprocessing``), and a group past its deadline is killed;
either raises in the caller.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch.distributed as dist
import torch.multiprocessing as mp

from solr_tpu_torch.parallel.distributed import initialize_distributed

__all__ = ["spawn_group"]


def _rank_main(rank, fn, world, args, backend, device, workdir, timeout_s):
    initialize_distributed(f"file://{os.path.join(workdir, 'rendezvous')}",
                           world, rank, backend=backend, device=device,
                           retries=1, timeout_s=timeout_s)
    out = fn(rank, world, *args)  # on an error the process ends at once
    dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class Group:
    """A started group: :meth:`join` waits for it and returns each
    rank's result; :meth:`close` ends it without waiting."""

    def __init__(self, context, workdir, world, deadline):
        self._context, self._workdir = context, workdir
        self._world, self._deadline = world, deadline

    def join(self) -> list:
        try:
            while not self._context.join(timeout=0.2):
                if time.monotonic() > self._deadline:
                    raise TimeoutError(f"{self._world} ranks missed their "
                                       "deadline")
            results = []
            for rank in range(self._world):
                with open(os.path.join(self._workdir.name, f"rank{rank}.pkl"),
                          "rb") as f:
                    results.append(pickle.load(f))  # our own ranks wrote it
            return results
        finally:
            self.close()

    def close(self) -> None:
        """Kill any rank still running and remove the group's files."""
        for p in self._context.processes:
            if p.is_alive():
                p.kill()
                p.join()
        self._workdir.cleanup()


def spawn_group(fn, world: int, args=(), backend: str = "gloo",
                device="cuda", timeout_s: float = 300.0) -> Group:
    """Start ``fn(rank, world, *args)`` on ``world`` spawned ranks of a
    fresh process group (``backend``, ``device``; collectives time out
    after ``timeout_s``) and return at once; ``.join()`` returns the
    ranks' return values, in rank order.  ``fn`` must be importable (a
    module-level function) and its results picklable."""
    workdir = tempfile.TemporaryDirectory(prefix="solr_group_")
    context = mp.start_processes(
        _rank_main, args=(fn, world, tuple(args), backend, str(device),
                          workdir.name, timeout_s),
        nprocs=world, join=False, start_method="spawn")
    return Group(context, workdir, world, time.monotonic() + timeout_s)
