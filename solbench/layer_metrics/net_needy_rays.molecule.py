"""Rays that the exactness net took per frame over the window
(``traverse.NET_STATS["needy_rays"]``), in the cells that report
``rays_per_s.molecule``; nothing where there is nothing to read."""

from solbench.layer_metrics_common import net_per_frame

UNIT, LAYER, MOVES = "rays/frame", "exactness net", "rays_per_s.molecule"


def read(inputs):
    return net_per_frame(inputs, "needy_rays")
