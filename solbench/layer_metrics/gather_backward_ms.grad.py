"""Device time per gradient step of the gathers' backward, by either
kernel that computes it: PyTorch's index backward
(``indexing_backward_kernel*``) or the port's ``gather_rows_bwd``
(``csrc/gather.cu``), from the profiled steps."""

from solbench.layer_metrics_common import kernel_ms

UNIT, LAYER, MOVES = "ms/step", "backward", "grad_step_ms"
NAMES = ("indexing_backward_kernel", "gather_rows_bwd")


def read(inputs):
    return kernel_ms(inputs, "grad", NAMES)
