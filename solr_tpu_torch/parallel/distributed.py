"""Multi-process bring-up on ``torch.distributed`` (counterpart of
solr_tpu/parallel/distributed.py).

The reference wires ``jax.distributed.initialize``; here each process
is one rank that drives one device, and ``initialize_distributed``
starts the default process group from arguments or the environment,
with bounded retry (rendezvous races at bring-up are the usual
multi-host flake).  The backend is the caller's choice: NCCL for CUDA
by default, gloo for the CPU or when asked for, as when several ranks
share one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from solr_tpu_torch.utils.logging import log_info, log_warning

__all__ = ["initialize_distributed", "is_distributed", "process_info"]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_distributed() -> bool:
    return _initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    """Identity of this process in the job (for logs and metrics), with
    the reference's keys.  A rank drives one device, so the job's
    devices are its ranks."""
    world = dist.get_world_size() if _initialized() else 1
    return {
        "process_index": dist.get_rank() if _initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    retries: int = 3,
    retry_wait_s: float = 5.0,
    timeout_s: float = 600.0,
) -> dict:
    """Start the default process group; safe to call in one process.

    Each field resolves in this order: the argument; then
    ``SOLR_COORDINATOR``, ``SOLR_NUM_PROCESSES`` and
    ``SOLR_PROCESS_ID``; then torchrun's ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  A launch with no coordinator is a
    no-op, so the same entry point serves one process and many.
    ``coordinator_address`` is ``host:port`` (TCP rendezvous) or any
    ``init_method`` URL such as ``file:///shared/path``.

    ``backend`` defaults to NCCL when ``device`` is CUDA and gloo on the
    CPU; pass ``"gloo"`` for CUDA tensors when ranks share a card.  On
    CUDA the rank's card is ``device`` when it names one, else
    ``LOCAL_RANK`` (or the rank) modulo the card count.  Collectives
    that wait longer than ``timeout_s`` raise on every rank.  Returns
    :func:`process_info` after bring-up; raises RuntimeError when the
    last of ``retries`` attempts fails.
    """
    if _initialized():
        return process_info()
    coordinator_address = coordinator_address or os.environ.get(
        "SOLR_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("SOLR_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("SOLR_PROCESS_ID", "RANK")
    if coordinator_address is None:
        return process_info()  # one process
    if num_processes is None or process_id is None:
        raise ValueError("a launch with a coordinator needs the process "
                         "count and id")

    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        index = device.index
        if index is None:
            local = _env_int("LOCAL_RANK")
            index = (process_id if local is None else local) \
                % torch.cuda.device_count()
        torch.cuda.set_device(index)
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")

    last = None
    for attempt in range(retries):
        try:
            dist.init_process_group(
                backend, init_method=init_method, world_size=num_processes,
                rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
            info = process_info()
            log_info(1, "distributed up (%s): %s", backend, info)
            return info
        except (RuntimeError, ValueError, OSError) as e:  # rendezvous race
            last = e
            log_warning("init_process_group failed (attempt %d/%d): %s",
                        attempt + 1, retries, e)
            time.sleep(retry_wait_s * (attempt + 1))
    raise RuntimeError(
        f"multi-process bring-up failed after {retries} attempts") from last
