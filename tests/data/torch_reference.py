"""Reference side of the PyTorch port's parity checks.

Helpers the ``tests/test_torch_*.py`` files share (the reference scenes
built from the same arrays as the port's, and flattening reference
objects to numpy), plus the script that wrote ``torch_bench_ref.npz``
and ``torch_molecule_ref.npz``: a reduced bench frame and a reduced
molecule frame rendered by ``solr_tpu`` on the CPU, which
``chip_smoke.py`` holds the port's frames on the GPU against.

    JAX_PLATFORMS=cpu python tests/data/torch_reference.py [bench] [molecule]

(both when no frame is named).  The script sets SOLR_PACKET_BLOCK
before importing ``solr_tpu``, so run it as its own process, once per
frame whose BLOCK differs.
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


def write_bench_ref():
    jax = _setup(REF_BLOCK)
    from solr_tpu_torch.bench_scene import bench_scene_arrays

    arrays = bench_scene_arrays(REF_TRIS)
    scene, cam, cfg = reference_bench_scene(arrays, REF_SIZE, REF_SIZE,
                                            REF_BOUNCES)
    img = reference_render(scene, cam, cfg)
    assert np.isfinite(img).all()
    np.savez_compressed(REF_FILE, image=img, n_tris=REF_TRIS, size=REF_SIZE,
                        block=REF_BLOCK, bounces=REF_BOUNCES,
                        jax_version=jax.__version__)
    print(f"wrote {REF_FILE}: digest {float(img.sum())!r}")


def write_molecule_ref():
    jax = _setup(MOL_BLOCK)
    from solr_tpu_torch.molecule_scene import molecule_scene_parts

    parts = molecule_scene_parts(MOL_ATOMS, MOL_GROUND_RES)
    with tempfile.TemporaryDirectory() as tmp:
        scene, cam, cfg = reference_molecule_scene(parts, MOL_SIZE, MOL_SIZE,
                                                   MOL_BOUNCES, tmp)
    assert None not in (scene.tri_accel, scene.sph_accel, scene.cyl_accel)
    img = reference_render(scene, cam, cfg)
    assert np.isfinite(img).all()
    np.savez_compressed(
        MOL_REF_FILE, image=img, n_atoms=MOL_ATOMS,
        ground_res=MOL_GROUND_RES, size=MOL_SIZE, block=MOL_BLOCK,
        bounces=MOL_BOUNCES, pdb_sha256=pdb_sha256(parts["pdb"]),
        jax_version=jax.__version__)
    print(f"wrote {MOL_REF_FILE}: digest {float(img.sum())!r}")


FRAMES = {"bench": write_bench_ref, "molecule": write_molecule_ref}


def main(argv):
    names = argv or list(FRAMES)
    if len(names) > 1:  # one process per frame: each sets its own BLOCK
        for name in names:
            subprocess.run([sys.executable, __file__, name], check=True)
        return
    FRAMES[names[0]]()


if __name__ == "__main__":
    main(sys.argv[1:])
