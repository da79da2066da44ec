"""CUDA kernels per gradient step (copies left out), from the profiled
steps."""

from solbench.layer_metrics_common import kernels_per_unit

UNIT, LAYER, MOVES = "kernels/step", "bounce loop", "grad_step_ms"


def read(inputs):
    return kernels_per_unit(inputs, "grad")
