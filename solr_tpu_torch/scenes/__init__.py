"""The demo scene gallery (counterpart of solr_tpu/scenes): 22
registered scenes that double as the integration corpus, and
``make_scene``."""

from solr_tpu_torch.scenes import gallery as _gallery  # noqa: F401 (registers)
from solr_tpu_torch.scenes.base import SCENE_REGISTRY, DemoScene, register_scene

__all__ = ["DemoScene", "SCENE_REGISTRY", "register_scene", "make_scene"]


def make_scene(name: str, **kwargs) -> DemoScene:
    """Instantiate the registered scene ``name`` (``seed``, ``device``
    and the scene's own arguments as keywords) and initialize it."""
    demo = SCENE_REGISTRY[name](**kwargs)
    demo.initialize()
    return demo
