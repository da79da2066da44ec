"""Engine: a stateful shell over the functional renderer (counterpart of
solr_tpu/engine.py).

It owns a SceneBuilder, a camera, the render configuration, the random
key and the progressive accumulation buffer: ``add_*`` calls go to the
builder and mark the scene dirty, ``render_frame`` renders one sample
and folds it into the running average, and keyframed animation morphs
between two scenes of the same topology.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from solr_tpu_torch.ops.render import accumulate, render
from solr_tpu_torch.ops.rng import Key
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import Camera, RenderConfig, Scene

__all__ = ["Engine", "morph_scenes"]


class Engine:
    """Progressive renderer: each :meth:`render_frame` adds one sample
    to the running average until the scene or camera changes."""

    def __init__(self, config: Optional[RenderConfig] = None,
                 camera: Optional[Camera] = None, seed: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        self.builder = SceneBuilder()
        self.config = config or RenderConfig()
        self.camera = camera or Camera.create(device=self.device)
        self._scene: Optional[Scene] = None
        self._dirty = True
        self._accum = None
        self._iteration = 0
        self._key = Key.seed(seed, self.device)
        self._nb_frames = 1
        self._frame = 0
        self._keyframes = None

    # -- scene construction --------------------------------------------

    def __getattr__(self, name):
        # add_* scene-building calls go to the builder.
        if name.startswith("add_"):
            self.__dict__["_dirty"] = True
            return getattr(self.builder, name)
        raise AttributeError(name)

    @property
    def scene(self) -> Scene:
        if self._dirty or self._scene is None:
            self._scene = self.builder.build(use_bvh=self.config.use_bvh,
                                             device=self.device)
            self._dirty = False
            self.reset_accumulation()
        return self._scene

    def set_scene(self, scene: Scene) -> None:
        self._scene = scene
        self._dirty = False
        self.reset_accumulation()

    def reset_accumulation(self) -> None:
        self._accum = None
        self._iteration = 0

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera
        self.reset_accumulation()

    # -- animation -------------------------------------------------------

    def set_nb_frames(self, n: int) -> None:
        """Declare the animation length."""
        self._nb_frames = int(n)
        self._frame = 0

    @property
    def frame(self) -> int:
        return self._frame

    def set_keyframes(self, scene_a: Scene, scene_b: Scene) -> None:
        """Frames morph from ``scene_a`` to ``scene_b`` (same topology)."""
        self._keyframes = (scene_a, scene_b)

    def next_frame(self) -> Scene:
        """Advance the animation and return the frame's scene: with
        keyframes, the morph at frame / (nb_frames - 1); else the static
        scene."""
        self._frame = (self._frame + 1) % max(self._nb_frames, 1)
        self.reset_accumulation()
        return self.frame_scene()

    def frame_scene(self) -> Scene:
        if self._keyframes is None:
            return self.scene
        t = self._frame / max(self._nb_frames - 1, 1)
        self._scene = morph_scenes(*self._keyframes, t)
        self._dirty = False
        return self._scene

    # -- rendering -------------------------------------------------------

    @torch.no_grad()
    def render_frame(self) -> np.ndarray:
        """One progressive sample, accumulated; (H, W, 4) float."""
        self._key, sub = self._key.split()
        img = render(self.scene, self.camera, self.config, sub)
        if self._accum is None:
            self._accum = img
        else:
            self._accum = accumulate(self._accum, img, self._iteration)
        self._iteration += 1
        return self._accum.cpu().numpy()

    def bitmap(self) -> np.ndarray:
        """The current frame as (H, W, 3) uint8."""
        if self._accum is None:
            self.render_frame()
        rgb = torch.clamp(self._accum[..., :3], 0.0, 1.0) * 255.0
        return rgb.cpu().numpy().astype(np.uint8)


def _lerp(a, b, t: float):
    """Floating tensors lerp; everything else comes from ``a``."""
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: _lerp(getattr(a, f.name),
                                        getattr(b, f.name), t)
                          for f in dataclasses.fields(a)})
    if isinstance(a, torch.Tensor) and a.is_floating_point():
        w = torch.tensor(t, dtype=torch.float32, device=a.device)
        return a * (1.0 - w) + b * w  # t and 1 - t in f32, as the reference
    return a


def morph_scenes(scene_a: Scene, scene_b: Scene, t: float) -> Scene:
    """Linear morph between two scenes of the same topology: every
    floating tensor lerps (BVH node boxes included: the lerp of two
    boxes holds the lerp of what they held), integer tensors come from
    ``scene_a``, and the packet accelerators are rebuilt from the
    morphed geometry.  The morph is made of new tensors, so nothing
    derived from an earlier frame is reused."""
    keep = dict(tri_accel=scene_a.tri_accel, sph_accel=scene_a.sph_accel,
                cyl_accel=scene_a.cyl_accel)
    bare = dict.fromkeys(keep)
    morphed = _lerp(scene_a.replace(**bare), scene_b.replace(**bare),
                    float(t))
    return morphed.replace(**keep).refresh_accel()
