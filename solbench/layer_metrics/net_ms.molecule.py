"""Host ms per frame under the program's ``solr/net`` spans (the
exactness net), from the profiled frames, in the cells that report
``rays_per_s.molecule``.  The net's first sync waits for what the
stages before it queued, so that wait counts here; ``sweep_ms.molecule``
bounds it."""

from solbench.spans import span_ms

UNIT, LAYER, MOVES = "ms/frame", "exactness net", "rays_per_s.molecule"


def read(inputs):
    return span_ms(inputs, "frames", "net")
