"""Resumable row-band rendering and the heartbeat of the
failure-detection contract (counterpart of solr_tpu/utils/resumable.py).

A frame renders as row-band chunks.  After every chunk the partial
image and depth and the next chunk's index are checkpointed through
:class:`solr_tpu_torch.utils.checkpoint.CheckpointManager` (atomic
rotating writes) and a heartbeat file is touched, so a killed worker
loses at most one chunk: a supervisor that sees the heartbeat stall
relaunches the worker, which resumes from its newest checkpoint.  A
chunk's pixels depend only on (scene, camera, cfg, key, its rows), so
the resumed frame is bit-identical to an uninterrupted one.

A row band is the unit ``parallel.render`` shards over, so "rank i
renders rows [i*H/N, (i+1)*H/N)" and "rank i checkpoints its band chunk
by chunk" compose (``row0``, ``n_rows``).

Unlike the reference, the directory's fingerprint covers the chunk
height and the random key, and a directory with checkpoints but no
fingerprint is stale (ROADMAP C5, C15): each could otherwise resume
another render's chunks.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from solr_tpu_torch.ops.camera import camera_rays
from solr_tpu_torch.ops.render import trace_rays_tiled
from solr_tpu_torch.ops.rng import Key
from solr_tpu_torch.utils.checkpoint import (CheckpointManager, RenderState,
                                             latest_step)

__all__ = ["resumable_render", "touch_heartbeat", "heartbeat_age"]


def _tensors(obj):
    """The tensors and plain values of a tree of dataclasses, in field
    order."""
    import dataclasses

    if dataclasses.is_dataclass(obj):
        out = []
        for f in dataclasses.fields(obj):
            out += _tensors(getattr(obj, f.name))
        return out
    return [obj]


def _key_token(key) -> str:
    """What a chunk's draws depend on in ``key``: a :class:`Key`'s state,
    or a fixed token for no key.  Any other key would hash as nothing,
    so it raises."""
    if key is None:
        return "key:none"
    if isinstance(key, Key):
        return f"key:{key.state}"
    raise TypeError(f"resumable_render takes a solr_tpu_torch Key or None "
                    f"as its key, got {type(key).__name__}")


def _fingerprint(scene, camera, cfg, key, row0: int, n_rows: int,
                 rows_per_chunk: int) -> str:
    """Hash of everything a chunk's pixels and the checkpoints' layout
    depend on.  Large leaves hash a 64 KB prefix and their sum: cheap at
    1M triangles, and any edit of geometry, materials or camera moves
    one or the other."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(cfg).encode())
    h.update(_key_token(key).encode())
    h.update(f"rows:{row0}:{n_rows}:{rows_per_chunk}".encode())
    for leaf in _tensors(scene) + _tensors(camera):
        if not isinstance(leaf, torch.Tensor):
            h.update(repr(leaf).encode())
            continue
        a = leaf.detach().cpu().numpy()
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.reshape(-1)[:65536 // a.itemsize].tobytes())
        if a.size:
            h.update(np.asarray(a, np.float64).sum().tobytes())
    return h.hexdigest()


def touch_heartbeat(path: str) -> None:
    with open(path, "w") as f:
        f.write(str(time.time()))


def heartbeat_age(path: str) -> Optional[float]:
    """Seconds since the worker last made progress; None = no beat yet."""
    try:
        return time.time() - os.path.getmtime(path)
    except OSError:
        return None


def _render_rows(scene, camera, cfg, row0, n_rows, key):
    """Rows [row0, row0 + n_rows) of the frame: the whole frame's
    primary rays (so that a key's draws are the frame's), cut to the
    band and traced through the tiled path the full frame takes."""
    o, d = camera_rays(camera, cfg, key, scene.info.background_color.dtype)
    band = slice(row0 * cfg.width, (row0 + n_rows) * cfg.width)
    color, t = trace_rays_tiled(scene, o[band], d[band], cfg, key)
    return color.reshape(n_rows, cfg.width, 4), t.reshape(n_rows, cfg.width)


@torch.no_grad()
def resumable_render(scene, camera, cfg, directory: str,
                     rows_per_chunk: int = 32, key=None, row0: int = 0,
                     n_rows: Optional[int] = None,
                     heartbeat: Optional[str] = None,
                     chunk_sleep_s: float = 0.0, log=None,
                     cleanup: bool = False):
    """Render rows [row0, row0 + n_rows) in checkpointed chunks.

    Returns (image (n_rows, W, 4), depth (n_rows, W)).  On entry the
    newest checkpoint in ``directory`` restores the partial image and
    the render continues at the first unfinished chunk: a process killed
    at any point and launched again gives the same image.
    ``chunk_sleep_s`` slows chunks down so that a fault-injection run
    can kill mid-frame.  ``log(event=..., **fields)`` hears of
    "stale_checkpoint_discarded", "resumed" and each "chunk_done".

    A ``fingerprint`` file records a hash of (scene, camera, cfg, key,
    row range, ``rows_per_chunk``); a directory whose fingerprint
    differs, or that holds checkpoints without one, is stale and
    restarts from scratch.  ``key`` is a :class:`Key` or None; another
    type raises a TypeError.  ``cleanup=True`` removes the directory
    after the frame.
    """
    h = cfg.height if n_rows is None else n_rows
    if h % rows_per_chunk:
        raise ValueError(f"{h} rows not divisible by {rows_per_chunk}")
    n_chunks = h // rows_per_chunk
    fp = _fingerprint(scene, camera, cfg, key, row0, h, rows_per_chunk)
    fp_path = os.path.join(directory, "fingerprint")
    try:
        with open(fp_path) as f:
            stale = f.read().strip() != fp
    except FileNotFoundError:
        stale = latest_step(directory) is not None
    if stale:
        if log:
            log(event="stale_checkpoint_discarded", directory=directory)
        shutil.rmtree(directory, ignore_errors=True)
    ckpt = CheckpointManager(directory, keep_n=2)
    with open(fp_path, "w") as f:
        f.write(fp)
    dev = scene.device
    template = RenderState(
        params=torch.zeros((h, cfg.width), dtype=torch.float32, device=dev),
        opt_state=None, rng_state=None,
        accum=torch.zeros((h, cfg.width, 4), dtype=torch.float32, device=dev),
        iteration=0)
    state, at = ckpt.restore(template)
    start, accum, depth = state.iteration, state.accum, state.params
    if log and at is not None:
        log(event="resumed", from_chunk=start)

    for c in range(start, n_chunks):
        r0 = c * rows_per_chunk
        img, t = _render_rows(scene, camera, cfg, row0 + r0, rows_per_chunk,
                              key)
        accum[r0:r0 + rows_per_chunk] = img
        depth[r0:r0 + rows_per_chunk] = t
        ckpt.save(c + 1, RenderState(params=depth, opt_state=None,
                                     rng_state=None, accum=accum,
                                     iteration=c + 1))
        if heartbeat:
            touch_heartbeat(heartbeat)
        if log:
            log(event="chunk_done", chunk=c, rows=rows_per_chunk)
        if chunk_sleep_s:
            time.sleep(chunk_sleep_s)
    if cleanup:
        shutil.rmtree(directory, ignore_errors=True)
    return accum, depth
