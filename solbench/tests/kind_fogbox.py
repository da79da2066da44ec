"""A scene kind that lives only in the tests, ``fogbox``: the terrain
kind's ground and mirror spheres under fog, lit by one light of some
radius.  Its configuration and cell (``fogbox/``) state every render
setting a frame cell can state: soft shadows, fog, antialiasing jitter,
an ambient-occlusion pass, samples per pixel and a key.  The test
registers this module as the kind's scene module and its reference, so
nothing outside the tests names it.

Its reference ``render`` records what it is handed and renders with the
plain reference, which knows none of these settings: the test checks
the hand-over, not the image."""

from __future__ import annotations

from solbench.reference import render as ref
from solbench.reference import terrain as ref_terrain
from solbench.scenes import terrain

TINY = {"n_tris": 2000}
# What each reference frame was handed: dtype, settings, seed, workload.
CALLS = []

make_inputs = terrain.make_inputs
reference_scene = ref_terrain.reference_scene


def build_port(raw: dict, config: dict, device):
    """The terrain kind's scene and camera, with the configuration's
    fog distances in its scene info."""
    from solr_tpu_torch import SceneInfo

    scene, cam = terrain.build_port(raw, config, device)
    info = SceneInfo.create(**config["fog"], device=device)
    return scene.replace(info=info), cam


def render(scene, camera: dict, workload: dict, settings: dict, seed):
    CALLS.append(dict(dtype=scene.dtype, settings=dict(settings), seed=seed,
                      workload=dict(workload)))
    return ref.render(scene, camera, workload["width"], workload["height"],
                      workload["bounces"])
