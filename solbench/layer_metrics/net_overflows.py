"""Net chunks per frame whose block union overflowed into the whole-pool
brute force (``traverse.NET_STATS["overflows"]``) over the window, in
the cells that report ``rays_per_s``; nothing where there is nothing to
read."""

from solbench.layer_metrics_common import net_per_frame

UNIT, LAYER, MOVES = "overflows/frame", "exactness net", "rays_per_s"


def read(inputs):
    return net_per_frame(inputs, "overflows")
