"""Shadow rays that the exactness net took per frame over the window,
on the primary and later bounces (``traverse.NET_STATS``
``needy_primary_shadow`` + ``needy_later_shadow``), in the cells that
report ``rays_per_s``."""

from solbench.spans import needy_shadow_per_frame

UNIT, LAYER, MOVES = "rays/frame", "exactness net", "rays_per_s"


def read(inputs):
    return needy_shadow_per_frame(inputs)
