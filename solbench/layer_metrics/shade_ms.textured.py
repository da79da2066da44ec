"""Host ms per frame under the program's ``solr/shade`` spans (local
shading, ``shade.phong_shade``, its soft shadows' transmittance queries
included), from the profiled frames of the textured cell.  Nothing
where the program records no such span."""

from solbench.spans import intervals, span_ms, traced

UNIT, LAYER, MOVES = "ms/frame", "bounce loop", "rays_per_s"


def read(inputs):
    trace = traced(inputs, "frames")
    if trace is None or not intervals(trace, "shade"):
        return None
    return span_ms(inputs, "frames", "shade")
