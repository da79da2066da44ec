"""CUDA kernels per frame (copies left out), from the profiled frames of
the textured cell."""

from solbench.layer_metrics_common import kernels_per_unit

UNIT, LAYER, MOVES = "kernels/frame", "bounce loop", "rays_per_s"


def read(inputs):
    return kernels_per_unit(inputs, "frames")
