"""The Cornell box of the reference's gallery (solr_tpu/scenes/gallery.py:
24-42), built without the reference package: five walls (axis-aligned
planes), a mirror sphere, a glass sphere and one light, seen from inside
the open front.

``cornell_scene`` builds this package's scene, camera and config; its
defaults are BASELINE.json config #1's frame settings (256x256, 2
bounces).
"""

from __future__ import annotations

from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import Camera, PlaneAxis, RenderConfig

__all__ = ["cornell_scene"]

CAMERA = dict(position=(0.0, 0.0, -1.6), fov=1.1)


def cornell_scene(width: int = 256, height: int = 256, bounces: int = 2,
                  device="cuda"):
    """(scene, camera, config) of the Cornell box on ``device``."""
    b = SceneBuilder()
    white = b.add_material(color=(0.75, 0.75, 0.75, 1.0))
    red = b.add_material(color=(0.75, 0.15, 0.15, 1.0))
    green = b.add_material(color=(0.15, 0.75, 0.15, 1.0))
    mirror = b.add_material(color=(0.9, 0.9, 0.9, 1.0), reflection=0.7,
                            specular=0.8)
    glass = b.add_material(color=(0.95, 1.0, 0.95, 1.0), transparency=0.85,
                           ior=1.5)
    b.add_plane(PlaneAxis.XZ, (0, -1, 1), (1, 1), white)
    b.add_plane(PlaneAxis.XZ, (0, 1, 1), (1, 1), white)
    b.add_plane(PlaneAxis.YZ, (-1, 0, 1), (1, 1), red)
    b.add_plane(PlaneAxis.YZ, (1, 0, 1), (1, 1), green)
    b.add_plane(PlaneAxis.XY, (0, 0, 2), (1, 1), white)
    b.add_sphere((-0.45, -0.6, 1.2), 0.38, mirror)
    b.add_sphere((0.45, -0.62, 0.9), 0.36, glass)
    b.add_light((0.0, 0.85, 1.0), color=(1.0, 1.0, 0.95, 1.0), radius=0.12)
    scene = b.build(device=device)
    cam = Camera.create(device=device, **CAMERA)
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces)
    return scene, cam, cfg
