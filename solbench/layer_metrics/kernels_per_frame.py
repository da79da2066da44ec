"""CUDA kernels per frame (copies left out), from the profiled frames, in
the cells that report ``rays_per_s``; nothing where there is nothing to
read."""

from solbench.layer_metrics_common import kernels_per_unit

UNIT, LAYER, MOVES = "kernels/frame", "bounce loop", "rays_per_s"


def read(inputs):
    return kernels_per_unit(inputs, "frames")
