"""Share of the profiled steps' span in which no kernel or copy ran on the
device: 100 (1 - union of their intervals / span)."""

from solbench.layer_metrics_common import idle_pct

UNIT, LAYER, MOVES = "%", "device", "grad_step_ms"


def read(inputs):
    return idle_pct(inputs, "grad")
