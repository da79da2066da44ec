"""Structured per-step metrics (counterpart of solr_tpu/utils/metrics.py).

* :class:`MetricsLogger` appends one JSON object per step to a file
  and/or a stream, with a step counter and wall-clock seconds.
* :class:`RaysMeter` is a wall-clock rays/s meter with an exponential
  moving average.
* :func:`occupancy` and :func:`grad_norms` reduce a live mask and a
  gradient tree to numbers for the log.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Any, Dict, Optional

import numpy as np
import torch

__all__ = ["MetricsLogger", "RaysMeter", "occupancy", "grad_norms",
           "tree_leaves"]


def _plain(v):
    """A JSON-ready value: one-element tensors and numpy values as
    Python numbers, larger ones as lists."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.numel() == 1 else v.tolist()
    if isinstance(v, np.ndarray):
        return v.item() if v.size == 1 else v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


class MetricsLogger:
    """Append per-step metric dicts as JSONL.

    >>> m = MetricsLogger("run.jsonl")
    >>> m.log(rays_per_s=1.2e8, loss=0.012)
    """

    def __init__(self, path: Optional[str] = None,
                 stream: Optional[IO[str]] = None, echo: bool = False):
        self._fh = open(path, "a") if path else None
        self._stream = stream
        self._echo = echo
        self._step = 0
        self._t0 = time.time()

    def log(self, step: Optional[int] = None, **metrics: Any) -> Dict:
        rec = {"step": self._step if step is None else int(step),
               "t": round(time.time() - self._t0, 4)}
        rec.update({k: _plain(v) for k, v in metrics.items()})
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._stream:
            self._stream.write(line + "\n")
        if self._echo:
            sys.stdout.write(line + "\n")
        if step is None:
            self._step += 1
        return rec

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RaysMeter:
    """Wall-clock rays/s meter with an EMA readout.  Call
    :meth:`tick` once per completed (synchronized) frame."""

    def __init__(self, ema: float = 0.8):
        self._ema = ema
        self._rate = None
        self._last = None
        self.total_rays = 0

    def tick(self, n_rays: int) -> Optional[float]:
        now = time.time()
        self.total_rays += int(n_rays)
        if self._last is not None:
            inst = n_rays / max(now - self._last, 1e-9)
            self._rate = (inst if self._rate is None
                          else self._ema * self._rate + (1 - self._ema) * inst)
        self._last = now
        return self._rate

    @property
    def rays_per_s(self) -> Optional[float]:
        return self._rate


def occupancy(live) -> float:
    """Fraction of live rays in a wavefront buffer."""
    live = torch.as_tensor(live)
    return float(live.float().mean()) if live.numel() else 0.0


def tree_leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, depth
    first in insertion order; a path joins the keys and indices with
    "/".  None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += tree_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def grad_norms(grads) -> Dict[str, float]:
    """Per-leaf L2 norms of a gradient tree (dicts, lists and tuples of
    tensors), keyed by path."""
    return {k: float(torch.linalg.vector_norm(
                torch.as_tensor(v).detach().double()))
            for k, v in tree_leaves(grads)}
