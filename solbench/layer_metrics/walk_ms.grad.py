"""Device time per gradient step of the BVH walk kernels
(``csrc/bvh_walk.cu``), from the profiled steps."""

from solbench.layer_metrics_common import kernel_ms

UNIT, LAYER, MOVES = "ms/step", "walk kernels", "grad_step_ms"
NAMES = ("closest_pairs", "trans_pairs")


def read(inputs):
    return kernel_ms(inputs, "grad", NAMES)
