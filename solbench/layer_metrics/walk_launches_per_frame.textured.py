"""Walk kernel launches per frame over the window (the program's
``ops.bvh.LAUNCHES``, summed over its kernels), in the textured cell;
nothing where the program launched no walk."""

UNIT, LAYER, MOVES = "launches/frame", "walk kernels", "rays_per_s"


def read(inputs):
    launches = sum(inputs.counters.get("walk", {}).values())
    if inputs.mode != "frames" or not launches or not inputs.window_units:
        return None
    return launches / inputs.window_units
