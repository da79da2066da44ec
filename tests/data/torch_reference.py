"""Reference side of the PyTorch port's parity checks.

Helpers the ``tests/test_torch_*.py`` files share (the reference scenes
built from the same arrays as the port's, and flattening reference
objects to numpy), plus the script that wrote the reduced frames
that ``chip_smoke.py`` holds the port's frames on the GPU against, each
rendered by ``solr_tpu`` on the CPU:

* ``torch_bench_ref.npz``: the bench frame at 64x64 (packets);
* ``torch_molecule_ref.npz``: the molecule frame at 64x64 (packets);
* ``torch_walk_ref.npz``: the bench frame at 64x56, a height that is
  not a multiple of the 16-pixel tile, so the triangle pool takes the
  per-ray BVH walk;
* ``torch_molecule_while_ref.npz``: the molecule frame at 64x64 with
  traversal="while", so all three pools walk their BVHs;
* ``torch_cornell_ref.npz``: the gallery's Cornell box at 64x64
  (planes and spheres, brute force).

    JAX_PLATFORMS=cpu python tests/data/torch_reference.py [name ...]

with names from ``FRAMES`` (all when none is named).  The script sets
SOLR_PACKET_BLOCK before importing ``solr_tpu``, so it runs each frame
in a process of its own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REF_FILE = os.path.join(HERE, "torch_bench_ref.npz")
MOL_REF_FILE = os.path.join(HERE, "torch_molecule_ref.npz")

# The reduced bench frame: the bench's scene, materials, camera and
# packet widths, cut to 20,000 triangles and 64x64 pixels.
REF_TRIS = 20_000
REF_SIZE = 64
REF_BLOCK = 512
REF_BOUNCES = 2

# The reduced molecule frame: the molecule frame's materials, light,
# camera and packet widths, cut to 2,000 atoms, a res-32 ground and
# 64x64 pixels, at the reference's default BLOCK.
MOL_ATOMS = 2_000
MOL_GROUND_RES = 32
MOL_SIZE = 64
MOL_BLOCK = 256
MOL_BOUNCES = 2

# The walk frames: the reduced bench frame at a height that is not a
# multiple of 16, and the reduced molecule frame with traversal="while".
WALK_REF_FILE = os.path.join(HERE, "torch_walk_ref.npz")
WALK_HEIGHT = 56
MOL_WHILE_REF_FILE = os.path.join(HERE, "torch_molecule_while_ref.npz")

# The gallery's Cornell box (solr_tpu/scenes/gallery.py:24-42) at 64x64.
CORNELL_REF_FILE = os.path.join(HERE, "torch_cornell_ref.npz")
CORNELL_SIZE = 64
CORNELL_BOUNCES = 2


def pdb_sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def numpy_tree(obj):
    """Flatten a reference dataclass (Scene, Camera, ...) to nested
    dicts of numpy arrays; ints, floats and None pass through."""
    if dataclasses.is_dataclass(obj):
        return {f.name: numpy_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (int, float, bool, str)):
        return obj
    return np.asarray(obj)


def reference_bench_scene(arrays, width, height, bounces):
    """The bench frame built by ``solr_tpu`` from
    ``solr_tpu_torch.bench_scene.bench_scene_arrays`` output, as
    bench.py:66-132 builds it."""
    import solr_tpu as st

    b = st.SceneBuilder()
    terrain = b.add_material(**arrays["terrain_material"])
    mirror = b.add_material(**arrays["mirror_material"])
    b.add_mesh(arrays["vertices"], arrays["faces"], terrain)
    for c, r in zip(arrays["sphere_centers"], arrays["sphere_radii"]):
        b.add_sphere(tuple(c), float(r), mirror)
    b.add_light(arrays["light_position"], intensity=arrays["light_intensity"])
    scene = b.build(bvh_threshold=arrays["bvh_threshold"])
    cam = st.Camera.create(**arrays["camera"])
    cfg = st.RenderConfig(width=width, height=height, max_bounces=bounces,
                          **arrays["config"])
    return scene, cam, cfg


def reference_molecule_scene(parts, width, height, bounces, pdb_dir):
    """The molecule frame built by ``solr_tpu`` from
    ``solr_tpu_torch.molecule_scene.molecule_scene_parts`` output, in the
    port's order (molecule, ground, light).  The reference's
    ``load_pdb`` reads a file: the PDB text is written into
    ``pdb_dir``."""
    import solr_tpu as st
    from solr_tpu.io import load_pdb

    path = os.path.join(pdb_dir, "molecule.pdb")
    with open(path, "w") as f:
        f.write(parts["pdb"])
    b = st.SceneBuilder()
    load_pdb(path, b, **parts["load"])
    ground = b.add_material(**parts["ground_material"])
    b.add_mesh(parts["ground_vertices"], parts["ground_faces"], ground)
    b.add_light(parts["light_position"], intensity=parts["light_intensity"])
    scene = b.build(bvh_threshold=parts["bvh_threshold"])
    cam = st.Camera.create(**parts["camera"])
    cfg = st.RenderConfig(width=width, height=height, max_bounces=bounces,
                          **parts["config"])
    return scene, cam, cfg


def reference_render(scene, cam, cfg):
    """``solr_tpu.render_sample`` jitted; returns the image as numpy."""
    import jax

    from solr_tpu.ops.render import render_sample

    img, _ = jax.jit(render_sample, static_argnums=2)(scene, cam, cfg)
    return np.asarray(img, np.float32)


def _setup(block):
    os.environ["SOLR_PACKET_BLOCK"] = str(block)
    sys.path.insert(0, os.path.abspath(os.path.join(HERE, "..", "..")))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from solr_tpu.ops import packet as pk

    assert pk.BLOCK == block
    return jax


def _save(path, img, **meta):
    import jax

    assert np.isfinite(img).all()
    np.savez_compressed(path, image=img, jax_version=jax.__version__, **meta)
    print(f"wrote {path}: digest {float(img.sum())!r}")


def write_bench_ref(height=REF_SIZE, path=REF_FILE):
    _setup(REF_BLOCK)
    from solr_tpu_torch.bench_scene import bench_scene_arrays

    arrays = bench_scene_arrays(REF_TRIS)
    scene, cam, cfg = reference_bench_scene(arrays, REF_SIZE, height,
                                            REF_BOUNCES)
    _save(path, reference_render(scene, cam, cfg), n_tris=REF_TRIS,
          size=REF_SIZE, height=height, block=REF_BLOCK, bounces=REF_BOUNCES)


def write_molecule_ref(traversal="auto", path=MOL_REF_FILE):
    _setup(MOL_BLOCK)
    from solr_tpu_torch.molecule_scene import molecule_scene_parts

    parts = molecule_scene_parts(MOL_ATOMS, MOL_GROUND_RES)
    with tempfile.TemporaryDirectory() as tmp:
        scene, cam, cfg = reference_molecule_scene(parts, MOL_SIZE, MOL_SIZE,
                                                   MOL_BOUNCES, tmp)
    assert None not in (scene.tri_accel, scene.sph_accel, scene.cyl_accel)
    cfg = dataclasses.replace(cfg, traversal=traversal)
    _save(path, reference_render(scene, cam, cfg), n_atoms=MOL_ATOMS,
          ground_res=MOL_GROUND_RES, size=MOL_SIZE, block=MOL_BLOCK,
          bounces=MOL_BOUNCES, traversal=traversal,
          pdb_sha256=pdb_sha256(parts["pdb"]))


def write_cornell_ref():
    _setup(256)
    import solr_tpu as st
    from solr_tpu.scenes import make_scene

    demo = make_scene("cornell", seed=0)
    cfg = st.RenderConfig(width=CORNELL_SIZE, height=CORNELL_SIZE,
                          max_bounces=CORNELL_BOUNCES)
    _save(CORNELL_REF_FILE, reference_render(demo.scene, demo.camera, cfg),
          size=CORNELL_SIZE, bounces=CORNELL_BOUNCES)


FRAMES = {
    "bench": write_bench_ref,
    "molecule": write_molecule_ref,
    "walk": lambda: write_bench_ref(WALK_HEIGHT, WALK_REF_FILE),
    "molecule_while": lambda: write_molecule_ref("while", MOL_WHILE_REF_FILE),
    "cornell": write_cornell_ref,
}


def main(argv):
    names = argv or list(FRAMES)
    if len(names) > 1:  # one process per frame: each sets its own BLOCK
        for name in names:
            subprocess.run([sys.executable, __file__, name], check=True)
        return
    FRAMES[names[0]]()


if __name__ == "__main__":
    main(sys.argv[1:])
