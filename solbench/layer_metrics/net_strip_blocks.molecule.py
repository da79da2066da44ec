"""Blocks per strip list of the exactness net over the window: the sum
of its 32-ray strips' list lengths over the strips it swept
(``traverse.NET_STATS["strip_blocks"] / ["strips"]``), in the cells
that report ``rays_per_s.molecule``; nothing where the net never ran
or keeps no strip lists."""

UNIT, LAYER, MOVES = "blocks/strip", "exactness net", "rays_per_s.molecule"


def read(inputs):
    net = inputs.counters.get("net", {})
    if inputs.mode != "frames" or not net.get("strips"):
        return None
    return net["strip_blocks"] / net["strips"]
