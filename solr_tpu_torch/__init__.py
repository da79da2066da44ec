"""solr_tpu_torch — the solr_tpu ray tracer ported to PyTorch and CUDA.

The package mirrors ``solr_tpu``'s module names, so each function's
counterpart is easy to find.  Plain tensor code is PyTorch; the Pallas
sweep kernels of the packet traversal and the per-ray BVH walk are
hand-written CUDA C++ for Hopper (``csrc/sweep.cu``,
``csrc/bvh_walk.cu``), built with nvcc at first use.  On CPU
tensors every kernel wrapper runs its plain PyTorch version.

``render(scene, camera, cfg, key, spp)`` is the top entry point: ``spp``
samples averaged, then post-processing.  Random draws take an explicit
:class:`Key` (``Key.seed(seed, device)``).  :class:`Engine` is the
progressive, animated shell around it, ``solr_tpu_torch.scenes`` the
demo gallery and ``python -m solr_tpu_torch.viewer`` the render CLI.

This package imports neither JAX nor ``solr_tpu``.
"""

from solr_tpu_torch.constants import RAY_EPS
from solr_tpu_torch.engine import Engine
from solr_tpu_torch.ops.render import render, render_sample
from solr_tpu_torch.ops.rng import Key
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import (BVH, Camera, CameraMode, Cylinders,
                                  Ellipsoids, Lights, Materials, PlaneAxis,
                                  Planes, PostFxConfig, PostFxMode,
                                  ProceduralKind, RenderConfig, Scene,
                                  SceneInfo, Spheres, Textures, Triangles,
                                  TriAccel)

__all__ = [
    "BVH", "Camera", "CameraMode", "Cylinders", "Ellipsoids", "Engine", "Key",
    "Lights", "Materials", "PlaneAxis", "Planes", "PostFxConfig",
    "PostFxMode", "ProceduralKind", "RAY_EPS", "RenderConfig", "Scene",
    "SceneBuilder", "SceneInfo", "Spheres", "Textures", "Triangles",
    "TriAccel", "render", "render_sample",
]
