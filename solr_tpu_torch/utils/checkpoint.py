"""Checkpoint / resume of inverse-rendering runs (counterpart of
solr_tpu/utils/checkpoint.py).

A :class:`RenderState` (the scene parameters, the optimizer's
``state_dict()``, a ``torch.Generator`` state, the progressive
accumulation buffer and the step) is written as one ``.npz`` per step,
its arrays keyed by their path in the state, atomically (a temporary
file, then a rename).  It is read back with ``allow_pickle=False`` into
a template of the same structure, which gives each leaf its type, dtype
and device: no pickled code runs on load, and a leaf missing on either
side raises.  :class:`CheckpointManager` keeps the newest ``keep_n``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from solr_tpu_torch.utils.metrics import tree_leaves

__all__ = ["RenderState", "save_render_state", "restore_render_state",
           "latest_step", "CheckpointManager"]


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Resumable state of a progressive render or optimization run."""

    params: Any  # Scene.params-like tree of tensors
    opt_state: Any  # torch.optim.Optimizer.state_dict() (or None)
    rng_state: Any  # torch.Generator.get_state() (or None)
    accum: Any  # (H, W, 4) accumulation buffer (or None)
    iteration: Any  # int step

    def as_tree(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def _flatten(state: RenderState) -> Dict[str, np.ndarray]:
    out = {}
    for key, leaf in tree_leaves(state.as_tree()):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        out[key] = np.asarray(leaf)
        if out[key].dtype == object:
            raise TypeError(f"leaf {key!r} is not an array or a number")
    return out


def save_render_state(path: str, state: RenderState) -> str:
    """Atomically write ``state`` to ``path`` (.npz)."""
    arrays = _flatten(state)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _like(template, arr: np.ndarray):
    """``arr`` as a leaf of the template's type, dtype and device."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(arr).to(dtype=template.dtype,
                                       device=template.device)
    if isinstance(template, np.ndarray):
        return arr.astype(template.dtype)
    return type(template)(arr.item())


def _rebuild(template, stored, prefix, seen):
    if template is None:
        return None
    if isinstance(template, (dict, list, tuple)):
        items = (template.items() if isinstance(template, dict)
                 else enumerate(template))
        built = [(k, _rebuild(v, stored, f"{prefix}/{k}" if prefix else str(k),
                              seen)) for k, v in items]
        if isinstance(template, dict):
            return dict(built)
        return type(template)(v for _, v in built)
    if prefix not in stored:
        raise KeyError(f"checkpoint is missing leaf {prefix!r}")
    seen.add(prefix)
    return _like(template, stored[prefix])


def restore_render_state(path: str, template: RenderState) -> RenderState:
    """Load a checkpoint into the structure of ``template``.  Every leaf
    in the file must match a template path and vice versa; a mismatch
    raises KeyError rather than resuming with stale defaults."""
    with np.load(path, allow_pickle=False) as data:
        stored = {k: data[k] for k in data.files}
    seen = set()
    tree = _rebuild(template.as_tree(), stored, "", seen)
    extra = set(stored) - seen
    if extra:
        raise KeyError(f"checkpoint {path!r} has leaves not in the template: "
                       f"{sorted(extra)[:5]}")
    return RenderState(**tree)


_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


def _steps(directory: str):
    return [int(m.group(1)) for f in os.listdir(directory)
            if (m := _CKPT_RE.match(f))]


def latest_step(directory: str) -> Optional[int]:
    """Highest step with a complete checkpoint in ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


class CheckpointManager:
    """Rotating checkpoint directory: keeps the newest ``keep_n`` states
    and resumes from the latest."""

    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def save(self, step: int, state: RenderState) -> str:
        p = save_render_state(self.path(step), state)
        for s in sorted(_steps(self.directory))[:-self.keep_n]:
            try:
                os.unlink(self.path(s))
            except FileNotFoundError:
                pass
        return p

    def restore(self, template: RenderState, step: Optional[int] = None):
        """(state, step) for ``step`` or the latest; (template, None)
        when the directory holds no checkpoint yet."""
        if step is None:
            step = latest_step(self.directory)
        if step is None:
            return template, None
        return restore_render_state(self.path(step), template), step
