"""Host syncs per frame inside the program's spans: the CUDA runtime's
stream, device and event synchronisations that start under a ``solr/``
span, from the profiled frames, in the cells that report
``rays_per_s.molecule``."""

from solbench.spans import syncs_per_unit

UNIT, LAYER, MOVES = "syncs/frame", "bounce loop", "rays_per_s.molecule"


def read(inputs):
    return syncs_per_unit(inputs, "frames")
