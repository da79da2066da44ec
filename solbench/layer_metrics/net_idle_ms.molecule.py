"""ms per frame under the program's ``solr/net`` spans in which no
kernel or copy ran on the device (the host between the net's small
ops), from the profiled frames, in the cells that report
``rays_per_s.molecule``."""

from solbench.spans import idle_ms

UNIT, LAYER, MOVES = "ms/frame", "exactness net", "rays_per_s.molecule"


def read(inputs):
    return idle_ms(inputs, "frames", "net")
