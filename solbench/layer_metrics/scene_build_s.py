"""Scene build: the host clock around the inputs' hand-over to the program
(``load_pdb``, ``SceneBuilder``, ``.build`` with its BVHs and packet
accelerators) up to a sync."""

UNIT, LAYER, MOVES = "s", "scene build", "setup_s"


def read(inputs):
    return inputs.scene_build_s
