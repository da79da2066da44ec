"""Device time per frame of the sweep kernels B1-B6 and their launch order
kernel (``csrc/sweep.cu``), from the profiled frames, in the cells that
report ``rays_per_s.molecule``; nothing where there is nothing to read."""

from solbench.layer_metrics_common import kernel_ms

UNIT, LAYER, MOVES = "ms/frame", "sweep kernels", "rays_per_s.molecule"
NAMES = ("closest_staged", "trans_staged", "order_kernel")


def read(inputs):
    return kernel_ms(inputs, "frames", NAMES)
