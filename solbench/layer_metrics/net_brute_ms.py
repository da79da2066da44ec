"""Host ms per frame of the whole-pool brute force that the exactness
net falls back to when a chunk's block union overflows: the
``solr/brute`` spans inside ``solr/net`` spans, from the profiled
frames."""

from solbench.spans import span_ms

UNIT, LAYER, MOVES = "ms/frame", "exactness net", "rays_per_s"


def read(inputs):
    return span_ms(inputs, "frames", "brute", inside="net")
