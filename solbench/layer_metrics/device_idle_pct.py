"""Share of the profiled frames' span in which no kernel or copy ran on the
device: 100 (1 - union of their intervals / span), in the cells that
report ``rays_per_s``; nothing where there is nothing to read."""

from solbench.layer_metrics_common import idle_pct

UNIT, LAYER, MOVES = "%", "device", "rays_per_s"


def read(inputs):
    return idle_pct(inputs, "frames")
