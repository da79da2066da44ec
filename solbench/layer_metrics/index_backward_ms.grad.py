"""Device time per gradient step of PyTorch's index backward
(``indexing_backward_kernel*``: the gathers' autograd behind
``Scene.with_params``), from the profiled steps."""

from solbench.layer_metrics_common import kernel_ms

UNIT, LAYER, MOVES = "ms/step", "backward", "grad_step_ms"
NAMES = ("indexing_backward_kernel",)


def read(inputs):
    return kernel_ms(inputs, "grad", NAMES)
