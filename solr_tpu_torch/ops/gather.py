"""Row gathers of a table whose backward is a kernel of the port.

``gather_rows(table, idx)`` is ``table[idx]``.  When grad mode is on and
the table requires grad, it is an autograd Function whose backward adds
the incoming rows into a zeroed (N, ...) gradient at ``idx``
(:func:`gather_rows_bwd`); otherwise it is the plain ``table[idx]``, so
frames under ``torch.no_grad`` run exactly the ops they ran before.

The gradient step's gathers pile hundreds of thousands of rows onto a
few indices: a ray that missed a pool still gathers the row its clamped
index points at (``torch.where`` then zeroes its gradient), and every
ray on a pool of a few rows or on one material lands on the same row.
PyTorch's own backward of ``table[idx]`` walks each run of equal indices
serially; ``csrc/gather.cu`` sums them warp by warp instead.

:func:`gather_rows_bwd` dispatches on the device of its tensors: CPU
tensors take the plain version (``index_add_`` into zeros, in row
order), CUDA tensors the kernel, built with nvcc at first use
(``sweep.compile_library``) and loaded with ctypes.  A build or launch
failure raises, and so does a table the kernel does not take (neither
float32 nor float64, or rows wider than 4 values); nothing falls back
to the plain version.  On the card the sums of equal indices come in an order that
changes from run to run (atomics).
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from solr_tpu_torch.ops import sweep

__all__ = ["DTYPES", "LAUNCHES", "MAX_WIDTH", "build", "gather_rows",
           "gather_rows_bwd", "gather_rows_bwd_plain", "launch",
           "load_library"]

# Kernel launches since the caller last zeroed this.
LAUNCHES = {"gather_rows_bwd": 0}

# The widest row, in values, that the kernel takes, and its value types.
MAX_WIDTH = 4
DTYPES = (torch.float32, torch.float64)

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "gather.cu"
_lib = None
_lock = threading.Lock()


def gather_rows_bwd_plain(grad, idx, n: int):
    """The gradient of ``table[idx]`` for a table of ``n`` rows:
    ``grad`` (idx.shape + row shape) added at ``idx`` into zeros (n,
    row shape), row by row in order."""
    row = grad.shape[idx.dim():]
    out = torch.zeros((n,) + row, dtype=grad.dtype, device=grad.device)
    return out.index_add_(0, idx.reshape(-1), grad.reshape((-1,) + row))


def load_library(path):
    """Load a compiled gather library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.solr_gather_rows_bwd.argtypes = [vp, vp, i64, i64, i32, i32, vp, vp]
    lib.solr_gather_rows_bwd.restype = i32
    lib.solr_gather_shared_bytes.argtypes = []
    lib.solr_gather_shared_bytes.restype = i64
    return lib


def build(verbose: bool = False) -> str:
    """Compile ``csrc/gather.cu`` for sm_90a (once per source and flag
    set) and load it.  Returns the compiler's output when it built, ''
    when the library was already there.  Raises on any failure."""
    global _lib
    with _lock:
        path, log = sweep.compile_library(_SRC.read_bytes(),
                                          stem="libsolr_gather",
                                          verbose=verbose)
        if _lib is None:
            _lib = load_library(path)
        return log


def _library():
    if _lib is None:
        build()
    return _lib


def launch(lib, grad, idx, n: int):
    """One launch of ``lib``'s kernel: what :func:`gather_rows_bwd_plain`
    returns, for float32 or float64 rows of 1-4 values and indices in
    [0, n) (on the CPU, the emulated kernel of the tests)."""
    row = grad.shape[idx.dim():]
    width = math.prod(row)
    if grad.dtype not in DTYPES or not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"gather_rows_bwd takes float32 or float64 rows "
                         f"of 1-{MAX_WIDTH} values; got {grad.dtype} rows "
                         f"of shape {tuple(row)}")
    if idx.device != grad.device:
        raise ValueError(f"idx is on {idx.device}, grad on {grad.device}")
    g = grad.contiguous()
    i = idx.to(torch.int64).contiguous()
    out = torch.zeros((n,) + row, dtype=grad.dtype, device=grad.device)
    stream = (torch.cuda.current_stream(grad.device).cuda_stream
              if grad.is_cuda else None)
    err = lib.solr_gather_rows_bwd(
        ctypes.c_void_p(g.data_ptr()), ctypes.c_void_p(i.data_ptr()),
        i.numel(), n, width, g.element_size(),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"gather_rows_bwd kernel launch failed: "
                           f"cudaError {err}")
    return out


def gather_rows_bwd(grad, idx, n: int):
    """The gradient of ``table[idx]`` for a table of ``n`` rows:
    :func:`gather_rows_bwd_plain` on CPU tensors, the kernel on CUDA
    tensors."""
    if grad.device.type == "cpu":
        return gather_rows_bwd_plain(grad, idx, n)
    out = launch(_library(), grad, idx, n)
    LAUNCHES["gather_rows_bwd"] += 1
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return gather_rows_bwd(grad, idx, ctx.rows), None


def gather_rows(table, idx):
    """``table[idx]`` for an integer tensor ``idx`` of indices in [0,
    N); with grad mode on and a table that requires grad, its backward
    is :func:`gather_rows_bwd`."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherRows.apply(table, idx)
    return table[idx]
