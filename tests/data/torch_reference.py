"""Reference side of the PyTorch port's parity checks.

Helpers the ``tests/test_torch_*.py`` files share (the reference scene
built from the same arrays as the port's, and flattening reference
objects to numpy), plus the script that wrote ``torch_bench_ref.npz``:
a reduced bench frame rendered by ``solr_tpu`` on the CPU, which
``chip_smoke.py`` holds the port's frame on the GPU against.

    JAX_PLATFORMS=cpu python tests/data/torch_reference.py

The script sets SOLR_PACKET_BLOCK before importing ``solr_tpu``, so run
it as its own process.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

REF_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_bench_ref.npz")

# The reduced bench frame: the bench's scene, materials, camera and
# packet widths, cut to 20,000 triangles and 64x64 pixels.
REF_TRIS = 20_000
REF_SIZE = 64
REF_BLOCK = 512
REF_BOUNCES = 2


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


def reference_render(scene, cam, cfg):
    """``solr_tpu.render_sample`` jitted; returns the image as numpy."""
    import jax

    from solr_tpu.ops.render import render_sample

    img, _ = jax.jit(render_sample, static_argnums=2)(scene, cam, cfg)
    return np.asarray(img, np.float32)


def main():
    os.environ["SOLR_PACKET_BLOCK"] = str(REF_BLOCK)
    sys.path.insert(0, os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "..")))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from solr_tpu.ops import packet as pk
    from solr_tpu_torch.bench_scene import bench_scene_arrays

    assert pk.BLOCK == REF_BLOCK
    arrays = bench_scene_arrays(REF_TRIS)
    scene, cam, cfg = reference_bench_scene(arrays, REF_SIZE, REF_SIZE,
                                            REF_BOUNCES)
    img = reference_render(scene, cam, cfg)
    assert np.isfinite(img).all()
    np.savez_compressed(REF_FILE, image=img, n_tris=REF_TRIS, size=REF_SIZE,
                        block=REF_BLOCK, bounces=REF_BOUNCES,
                        jax_version=jax.__version__)
    print(f"wrote {REF_FILE}: digest {float(img.sum())!r}")


if __name__ == "__main__":
    main()
