"""The collectives of ``parallel/`` over a mesh's process group.

Each takes a mesh (None: one process, no collective) and returns a new
tensor on the input's device, ordered by linear index where it
concatenates.  Only the list forms of ``all_gather`` and
``reduce_scatter`` are used, which every supported PyTorch has without
deprecation.

gloo runs some collectives on CUDA tensors itself and lacks others;
:func:`host_staged` is the one place that copies a collective's CUDA
tensors through host memory for gloo (ranks sharing one card), for the
collectives in ``HOST_STAGED``.  NCCL and CPU tensors never stage.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from solr_tpu_torch.parallel.mesh import (linear_index, mesh_group,
                                          mesh_ranks, mesh_size)

__all__ = ["all_gather", "all_reduce_sum", "reduce_scatter_sum",
           "broadcast", "ring_shift", "host_staged", "HOST_STAGED"]

# Collectives that gloo runs only on host tensors.  On the H100 host's
# torch 2.11, gloo ran all_reduce, broadcast, all_gather and
# reduce_scatter on CUDA tensors, and batch_isend_irecv of a CUDA tensor
# aborted the process (gloo::IoException: writev Bad address).
HOST_STAGED = frozenset({"send_recv"})


def host_staged(name: str, group, x: torch.Tensor) -> torch.Tensor:
    """``x`` as collective ``name`` must receive it on ``group``: a host
    copy when the backend is gloo, ``x`` lies on a card and gloo lacks
    ``name`` for CUDA tensors; else ``x`` itself."""
    if (x.is_cuda and name in HOST_STAGED
            and dist.get_backend(group) == "gloo"):
        return x.cpu()
    return x


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, by linear index."""
    group = mesh_group(mesh)
    if group is None:
        return x
    y = host_staged("all_gather", group, x.contiguous())
    parts = [torch.empty_like(y) for _ in range(mesh_size(mesh))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.device)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    group = mesh_group(mesh)
    if group is None:
        return x.clone()
    y = host_staged("all_reduce", group, x).clone()
    dist.all_reduce(y, group=group)
    return y.to(x.device)


def reduce_scatter_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's 1/N of the sum of every rank's ``x`` (the i-th of N
    equal runs along dim 0 for linear index i)."""
    group = mesh_group(mesh)
    if group is None:
        return x.clone()
    y = host_staged("reduce_scatter", group, x.contiguous())
    parts = list(y.chunk(mesh_size(mesh)))
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, [p.contiguous() for p in parts], group=group)
    return out.to(x.device)


def broadcast(x: torch.Tensor, src: int, mesh) -> torch.Tensor:
    """Linear index ``src``'s ``x`` on every rank (written into ``x``
    on the others, which must pass a tensor of its shape and dtype)."""
    group = mesh_group(mesh)
    if group is None:
        return x
    y = host_staged("broadcast", group, x).contiguous()
    dist.broadcast(y, mesh_ranks(mesh)[src], group=group)
    if y is not x:
        x.copy_(y)
    return x


def ring_shift(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ring's rotation (the reference's ``ppermute`` with perm
    i -> i - 1): send ``x`` to linear index i - 1, return what i + 1
    sent."""
    group = mesh_group(mesh)
    n = mesh_size(mesh)
    if group is None or n == 1:
        return x
    ranks, i = mesh_ranks(mesh), linear_index(mesh)
    y = host_staged("send_recv", group, x.contiguous())
    got = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y, ranks[(i - 1) % n], group),
           dist.P2POp(dist.irecv, got, ranks[(i + 1) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got.to(x.device)
