"""The Cornell box of the gallery (``solr_tpu_torch.scenes``, scene
"cornell"; the reference's solr_tpu/scenes/gallery.py:24-42): five walls
(axis-aligned planes), a mirror sphere, a glass sphere and one light,
seen from inside the open front.

``cornell_scene`` returns that scene, its camera and a config whose
defaults are BASELINE.json config #1's frame settings (256x256, 2
bounces).
"""

from __future__ import annotations

from solr_tpu_torch.scenes import make_scene
from solr_tpu_torch.types import RenderConfig

__all__ = ["cornell_scene"]


def cornell_scene(width: int = 256, height: int = 256, bounces: int = 2,
                  device="cuda"):
    """(scene, camera, config) of the Cornell box on ``device``."""
    demo = make_scene("cornell", device=device)
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces)
    return demo.scene, demo.camera, cfg
