"""Demo-scene base class (counterpart of solr_tpu/scenes/base.py): the
initialize / animate lifecycle, the ground helper, random materials over
the reflective / transparent / procedural matrix, and the default light.

Random draws come from ``np.random.default_rng(seed)`` in the
reference's order, so both packages build the same geometry from the
same seed.  Scenes and cameras are made on ``device``.
"""

from __future__ import annotations

from typing import Dict, Type

import numpy as np

from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import Camera, PlaneAxis, ProceduralKind

__all__ = ["SCENE_REGISTRY", "register_scene", "DemoScene"]

SCENE_REGISTRY: Dict[str, Type["DemoScene"]] = {}


def register_scene(name: str):
    def deco(cls):
        SCENE_REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


class DemoScene:
    """A scene built once and animated per frame.

    Subclasses implement ``do_initialize`` (geometry through
    ``self.builder``) and may implement ``do_animate(frame)``, returning
    the frame's (scene, camera)."""

    name = "base"
    default_camera = dict(position=(0.0, 0.0, -4.0), fov=1.0)

    def __init__(self, seed: int = 0, device="cuda"):
        self.device = device
        self.builder = SceneBuilder()
        self.rng = np.random.default_rng(seed)
        self.camera = Camera.create(device=device, **self.default_camera)
        self._scene = None

    def build(self, builder: SceneBuilder):
        """``builder``'s scene on this scene's device."""
        return builder.build(device=self.device)

    # -- lifecycle -----------------------------------------------------

    def initialize(self):
        self.do_initialize()
        self._scene = None
        return self

    @property
    def scene(self):
        if self._scene is None:
            self._scene = self.build(self.builder)
        return self._scene

    def animate(self, frame: int):
        """(scene, camera) of ``frame`` (the static scene by default)."""
        out = self.do_animate(frame)
        return out if out is not None else (self.scene, self.camera)

    def do_initialize(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def do_animate(self, frame: int):
        return None

    # -- helpers -------------------------------------------------------

    def add_ground(self, y: float = -1.0, extent: float = 10.0,
                   checker: bool = True):
        b = self.builder
        if checker:
            mat = b.add_material(color=(0.85, 0.85, 0.85, 1.0),
                                 procedural=ProceduralKind.CHECKER,
                                 procedural_scale=float(extent))
        else:
            mat = b.add_material(color=(0.7, 0.7, 0.7, 1.0))
        b.add_plane(PlaneAxis.XZ, (0.0, y, 0.0), (extent, extent), mat)
        return mat

    def random_material(self):
        """Diffuse, specular, mirror, glass or procedural, drawn from
        ``self.rng``."""
        b = self.builder
        kind = self.rng.integers(0, 5)
        color = tuple(self.rng.uniform(0.2, 1.0, 3)) + (1.0,)
        if kind == 0:
            return b.add_material(color=color)
        if kind == 1:
            return b.add_material(color=color, specular=0.8,
                                  specular_power=40.0)
        if kind == 2:
            return b.add_material(color=(0.95, 0.95, 0.95, 1.0),
                                  reflection=0.8, specular=0.9)
        if kind == 3:
            return b.add_material(color=color, transparency=0.85, ior=1.5)
        return b.add_material(
            color=color,
            procedural=ProceduralKind(int(self.rng.choice([1, 2, 3, 4]))),
            procedural_scale=6.0)

    def default_light(self, position=(5.0, 8.0, -5.0), intensity=1.0):
        return self.builder.add_light(position, intensity=intensity)
