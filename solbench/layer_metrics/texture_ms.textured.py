"""Host ms per frame under the program's ``solr/texture`` spans (the
texture lookups of ``ops/textures.py``: ``sample_texture``,
``material_map_scales`` and ``apply_normal_maps``, the sky's among
them), from the profiled frames of the textured cell; spans nested in
one of the same name count once.  Nothing where the program records no
such span."""

from solbench.spans import intervals, span_ms, traced

UNIT, LAYER, MOVES = "ms/frame", "textures", "rays_per_s"


def read(inputs):
    trace = traced(inputs, "frames")
    if trace is None or not intervals(trace, "texture"):
        return None
    return span_ms(inputs, "frames", "texture")
