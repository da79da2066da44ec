"""solr_tpu_torch — the solr_tpu ray tracer ported to PyTorch and CUDA.

The package mirrors ``solr_tpu``'s module names, so each function's
counterpart is easy to find.  Plain tensor code is PyTorch; the Pallas
sweep kernels of the packet traversal are hand-written CUDA C++ for
Hopper (``csrc/sweep.cu``), built with nvcc at first use.  On CPU
tensors every kernel wrapper runs its plain PyTorch version.

This package imports neither JAX nor ``solr_tpu``.
"""

from solr_tpu_torch.constants import RAY_EPS
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import (Camera, CameraMode, Lights, Materials,
                                  ProceduralKind, RenderConfig, Scene,
                                  SceneInfo, Spheres, Textures, Triangles,
                                  TriAccel)

__all__ = [
    "Camera", "CameraMode", "Lights", "Materials", "ProceduralKind",
    "RAY_EPS", "RenderConfig", "Scene", "SceneBuilder", "SceneInfo",
    "Spheres", "Textures", "Triangles", "TriAccel", "render_sample",
]
