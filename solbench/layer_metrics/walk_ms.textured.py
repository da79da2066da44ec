"""Device ms per frame of the BVH walk kernels (``csrc/bvh_walk.cu``'s
``closest_pairs`` and ``trans_pairs``), from the profiled frames of the
textured cell."""

from solbench.layer_metrics_common import kernel_ms

UNIT, LAYER, MOVES = "ms/frame", "walk kernels", "rays_per_s"
NAMES = ("closest_pairs", "trans_pairs")


def read(inputs):
    return kernel_ms(inputs, "frames", NAMES)
