"""Host ms per frame under the program's ``solr/postfx`` spans (the
post-processing pass, ``ops/postfx.apply_postfx``: the textured frame's
ambient occlusion), from the profiled frames of the textured cell.
Nothing where the program records no such span."""

from solbench.spans import intervals, span_ms, traced

UNIT, LAYER, MOVES = "ms/frame", "post-processing", "rays_per_s"


def read(inputs):
    trace = traced(inputs, "frames")
    if trace is None or not intervals(trace, "postfx"):
        return None
    return span_ms(inputs, "frames", "postfx")
