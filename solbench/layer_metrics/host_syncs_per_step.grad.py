"""Host syncs per gradient step inside the program's spans: the CUDA
runtime's stream, device and event synchronisations that start under a
``solr/`` span, from the profiled steps."""

from solbench.spans import syncs_per_unit

UNIT, LAYER, MOVES = "syncs/step", "bounce loop", "grad_step_ms"


def read(inputs):
    return syncs_per_unit(inputs, "grad")
