"""Host ms per gradient step under the program's ``solr/refresh`` span:
``Scene.with_params`` rebuilding the packet accelerators, from the
profiled steps."""

from solbench.spans import span_ms

UNIT, LAYER, MOVES = "ms/step", "scene build", "grad_step_ms"


def read(inputs):
    return span_ms(inputs, "grad", "refresh")
