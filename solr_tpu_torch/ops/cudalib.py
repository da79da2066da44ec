"""The CUDA kernel libraries of the port: how they are built, loaded and
launched, and which tensors take them.

Each source in ``solr_tpu_torch/csrc/`` is one library with a plain C
interface: compiled with nvcc for sm_90a (``NVCC_FLAGS``: no FMA
contraction, so the kernels agree bit for bit with their plain PyTorch
versions) into ``build/solr_tpu_torch/libsolr_{source}_{hash}.so`` at
first use, never at import (``native.cached_build``), and loaded with
ctypes.  A module with kernels holds its :func:`library` and declares
its entry points beside its wrappers.  A build or launch failure raises;
nothing falls back to the plain version.

The device rule of every wrapper (:func:`on_card`): CPU tensors take the
plain version, CUDA tensors the kernel, and any other device raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import torch

from solr_tpu_torch import native

__all__ = ["NVCC_FLAGS", "SMEM_LIMIT", "check_detached", "compile_library",
           "library", "nvcc", "on_card", "ptr", "raise_on", "stream"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
]

# The shared memory a CTA may take on the H100, in bytes (kMaxSmem in
# csrc/sweep.cu, which solr_sweep_smem_limit reports).
SMEM_LIMIT = 232_448


def nvcc() -> str:
    """The path of nvcc: under CUDA_HOME or CUDA_PATH, on PATH, or in
    /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels need the CUDA toolkit")


def compile_library(src: bytes, stem: str, verbose: bool = False):
    """Compile the CUDA source ``src`` for sm_90a into
    ``build/solr_tpu_torch/{stem}_{hash}.so``, unless it is there; the
    hash covers the source and ``NVCC_FLAGS``.  Returns (path, the
    compiler's output or ''); ``verbose`` adds ptxas's report of each
    kernel's registers, stack and spills."""
    return native.cached_build(
        stem, src + " ".join(NVCC_FLAGS).encode(),
        lambda out, srcs: [nvcc(), *NVCC_FLAGS,
                           *(["-Xptxas", "-v"] if verbose else []),
                           "-o", str(out), *map(str, srcs)],
        sources=[(".cu", src)])


def library(source: str, load) -> native.Library:
    """The library of ``csrc/{source}``, built at first use into
    ``libsolr_{stem of source}_{hash}.so`` and loaded by ``load(path)``,
    which declares its entry points."""
    src = _CSRC / source
    return native.Library(
        lambda verbose: compile_library(src.read_bytes(),
                                        f"libsolr_{src.stem}", verbose),
        load, src)


def ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def stream(device):
    """The current CUDA stream of ``device``, as a kernel entry takes it;
    the null stream for the CPU, where the tests run the kernels
    emulated."""
    if device.type != "cuda":
        return ctypes.c_void_p(None)
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def check_detached(name: str, *tensors):
    """Raise if grad mode is on and any of ``tensors`` requires grad.

    The differentiability contract: traversal runs detached and the hit
    distance is recomputed with autograd afterwards, so no traversal
    kernel needs a backward pass.  A kernel wrapper called on a tensor
    that requires grad, with grad mode on, breaks that contract; this
    guard says so rather than returning a result with no gradient."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() on "
            f"detached tensors (traversal runs detached, the hit distance "
            f"is recomputed with autograd)")


def on_card(x, kernels: str) -> bool:
    """The device rule: False for a CPU tensor ``x`` (the plain
    version), True for a CUDA one (the kernel); any other device raises
    ValueError, naming ``kernels``."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {kernels} kernel for device {x.device}")
    return True
