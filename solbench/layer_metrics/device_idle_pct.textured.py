"""Share of the textured cell's profiled frames in which no kernel or
copy ran on the device: 100 (1 - union of their intervals / span)."""

from solbench.layer_metrics_common import idle_pct

UNIT, LAYER, MOVES = "%", "device", "rays_per_s"


def read(inputs):
    return idle_pct(inputs, "frames")
