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
  (planes and spheres, brute force);
* ``torch_stereo_ref.npz``: the bench frame cut to 20,000 triangles at
  128x64, SIDE_BY_SIDE, with 32x8-pixel packet tiles (BASELINE config
  #5's single-card tiles: a strip is one pixel row);
* ``torch_anaglyph_ref.npz``: the gallery's anaglyph scene (the Cornell
  box, red/cyan) at 64x64;
* ``torch_textured_ref.npz``: ``solr_tpu_torch.textured_scene`` (BASELINE
  config #3) at 64x64 without a key (hard shadows, no jitter), with
  ambient occlusion (``image``), once more with FISHEYE
  (``image_fisheye``), and once with a lens (aperture 0.1) and depth of
  field (``image_dof``);
* ``torch_grad_ref.npz``: gradients by ``jax.grad`` of ``solr_tpu``
  (float32) for three reduced cases: examples/inverse.py's scene at
  64x64 from its perturbed start (the RGB-D loss over the pixels
  outside the silhouette mask, which the file also stores), and the
  reduced bench frame with packets (64x64) and with the walk (64x56),
  each the MSE against 0.8 times its own image (stored as the target).
  Vertex gradients are stored as their non-zero rows and those rows'
  indices.

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

# The gradient references (the "grads" entry).
GRAD_REF_FILE = os.path.join(HERE, "torch_grad_ref.npz")
GRAD_INVERSE_SIZE = 64
# A pixel is left out of a gradient comparison when its primary or
# bounce-1 ray meets a sphere with 0 <= disc < SILHOUETTE_REL * r^2 (disc
# = b^2 - c of the sphere test with a unit direction): there dt/dc grows
# as 1/sqrt(disc), so the last bits of disc decide the pixel's gradient
# (ROADMAP C10).
SILHOUETTE_REL = 1e-2
# The inverse demo's depth weight and perturbations (examples/inverse.py).
INVERSE_DEPTH_WEIGHT = 0.05
INVERSE_ALBEDO_SHIFT = [[0.25, -0.2, 0.15], [-0.1, 0.25, -0.2]]
INVERSE_LIGHT_SHIFT = [[-2.0, 0.0, 1.5]]
INVERSE_CENTER_SHIFT = [[0.15, -0.12, 0.1], [-0.12, 0.1, -0.08]]
INVERSE_RADIUS_SCALE = [1.12, 0.9]
GRAD_TARGET_SCALE = 0.8

# The stereo frame: the reduced bench scene at 128x64, side by side,
# with 32x8 tiles.
STEREO_REF_FILE = os.path.join(HERE, "torch_stereo_ref.npz")
STEREO_WIDTH, STEREO_HEIGHT = 128, 64
STEREO_TILE = (32, 8)
# The anaglyph Cornell box and the textured frame.
ANAGLYPH_REF_FILE = os.path.join(HERE, "torch_anaglyph_ref.npz")
TEXTURED_REF_FILE = os.path.join(HERE, "torch_textured_ref.npz")
TEXTURED_SIZE = 64
TEXTURED_BOUNCES = 3
TEXTURED_BLOCK = 256
# The textured frame's lens for the depth-of-field case.
TEXTURED_APERTURE = 0.1
TEXTURED_FOCAL = 7.0

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


def stereo_config(cfg, width=STEREO_WIDTH, height=STEREO_HEIGHT):
    """A bench RenderConfig (either package's) as config #5's stereo
    frame: SIDE_BY_SIDE with 32x8 tiles, at ``width`` x ``height``."""
    return dataclasses.replace(
        cfg, width=width, height=height, camera_mode=type(cfg.camera_mode)(2),
        packet_tile_w=STEREO_TILE[0], packet_tile_h=STEREO_TILE[1])


def reference_textured_scene(parts, width, height, bounces, **cfg_over):
    """``solr_tpu_torch.textured_scene``'s frame built by ``solr_tpu``
    from ``textured_scene_parts`` output, in the port's order; the
    config fields in ``cfg_over`` replace the scene's own."""
    import solr_tpu as st

    b = st.SceneBuilder()
    tid = {name: b.add_texture(parts["textures"][name])
           for name in parts["texture_order"]}

    def maps(m):
        return {slot: tid[name] for slot, name in m.items()}

    terrain = b.add_material(**parts["terrain_material"],
                             **maps(parts["terrain_maps"]))
    b.add_mesh(parts["vertices"], parts["faces"], terrain, uvs=parts["uvs"])
    for i, (mat, (c, r)) in enumerate(zip(parts["glass_materials"],
                                          parts["glass_spheres"])):
        g = b.add_material(**mat, **maps(parts["glass_maps"].get(i, {})))
        b.add_sphere(c, r, g)
    b.add_ellipsoid(*parts["ellipsoid"],
                    b.add_material(**parts["amber_material"],
                                   **maps(parts["amber_maps"])))
    mirror = b.add_material(**parts["mirror_material"],
                            **maps(parts["mirror_maps"]))
    axis, origin, half = parts["mirror_plane"]
    b.add_plane(st.types.PlaneAxis(int(axis)), origin, half, mirror)
    b.add_light(**parts["light"])
    b.info = st.SceneInfo.create(**parts["info"])
    scene = b.build()
    c = dict(parts["config"])
    mode = st.types.PostFxMode(int(c.pop("postfx_mode")))
    cfg = st.RenderConfig(width=width, height=height, max_bounces=bounces,
                          sky_texture=tid[parts["sky"]],
                          postfx=st.types.PostFxConfig(mode=mode), **c)
    cfg = dataclasses.replace(cfg, **cfg_over)
    return scene, st.Camera.create(**parts["camera"]), cfg


def reference_render(scene, cam, cfg):
    """``solr_tpu.render_sample`` jitted; returns the image as numpy."""
    import jax

    from solr_tpu.ops.render import render_sample

    img, _ = jax.jit(render_sample, static_argnums=2)(scene, cam, cfg)
    return np.asarray(img, np.float32)


def reference_inverse_scene():
    """examples/inverse.py's ``build_scene``, built by ``solr_tpu``
    (importing the example would set its JAX cache and import optax)."""
    import solr_tpu as st

    b = st.SceneBuilder()
    floor = b.add_material(color=(0.75, 0.75, 0.75, 1.0),
                           procedural=st.types.ProceduralKind.CHECKER,
                           procedural_scale=8.0)
    red = b.add_material(color=(0.85, 0.25, 0.2, 1.0), specular=0.4)
    teal = b.add_material(color=(0.15, 0.6, 0.65, 1.0), specular=0.6,
                          specular_power=30.0)
    b.add_plane(st.types.PlaneAxis.XZ, (0.0, -1.0, 0.0), (12.0, 12.0),
                floor)
    b.add_sphere((-1.1, 0.0, 0.8), 1.0, red)
    b.add_sphere((1.2, -0.3, 0.0), 0.7, teal)
    b.add_light((3.0, 6.0, -4.0), intensity=1.0, radius=0.2)
    cam = st.Camera.create(position=(0.0, 1.2, -5.0),
                           angles=(0.18, 0.0, 0.0), fov=1.0)
    return b.build(), cam


def inverse_start(params):
    """examples/inverse.py's perturbed start with ``--geometry``: albedos,
    light, the two spheres' centres and radii."""
    import jax.numpy as jnp

    def shift(x):
        return jnp.asarray(x, params["albedo"].dtype)

    start = dict(params)
    start["albedo"] = params["albedo"].at[1:3, :3].add(
        shift(INVERSE_ALBEDO_SHIFT))
    start["light_position"] = params["light_position"] + shift(
        INVERSE_LIGHT_SHIFT)
    start["sphere_center"] = params["sphere_center"].at[0:2].add(
        shift(INVERSE_CENTER_SHIFT))
    start["sphere_radius"] = params["sphere_radius"].at[0:2].mul(
        shift(INVERSE_RADIUS_SCALE))
    return start


def silhouette_mask(scene, cam, cfg, rel=SILHOUETTE_REL):
    """(H, W) bool, True where the pixel's primary or bounce-1 ray meets
    a sphere with 0 <= disc < rel * r^2, from ``solr_tpu``'s own rays:
    the camera's, and the continuation of the rays that stay live after
    the first hit, formed as trace_rays forms it."""
    import jax.numpy as jnp

    from solr_tpu.constants import RAY_EPS
    from solr_tpu.ops.camera import camera_rays
    from solr_tpu.ops.traverse import scene_closest_hit, surface_at
    from solr_tpu.ops.vecmath import normalize, reflect, refract

    dtype = scene.info.background_color.dtype
    o, d = camera_rays(cam, cfg, None, dtype)
    sph = scene.spheres
    r2 = jnp.where(sph.radius > 0.0, sph.radius * sph.radius, -1.0)

    def grazing(o, d):
        oc = o[:, None, :] - sph.center[None]
        b = jnp.sum(oc * d[:, None, :], -1)
        disc = b * b - (jnp.sum(oc * oc, -1) - r2[None])
        ahead = -b + jnp.sqrt(jnp.maximum(disc, 0.0)) > RAY_EPS
        return jnp.any((disc >= 0.0) & (disc < rel * r2[None]) & ahead
                       & (r2[None] > 0.0), -1)

    mask = grazing(o, d)
    hit = scene_closest_hit(scene, o, d, use_bvh=cfg.use_bvh)
    surf = surface_at(scene, hit, o, d)
    mats = scene.materials
    m = surf.material
    has_refr = mats.transparency[m] > 1e-4
    live = hit.valid & ((mats.transparency[m] > 1e-4)
                        | (mats.reflection[m] > 1e-4))
    n = surf.shading_normal
    eta = jnp.where(surf.backface, mats.ior[m],
                    1.0 / jnp.maximum(mats.ior[m], 1e-3))
    nd = normalize(jnp.where(has_refr[..., None], refract(d, n, eta)[0],
                             reflect(d, n)))
    mask = mask | (live & grazing(surf.point + nd * (RAY_EPS * 4.0), nd))
    return np.asarray(mask).reshape(cfg.height, cfg.width)


def reference_grads(scene, cam, cfg, params, target, target_depth=None,
                    mask=None, jit=False):
    """``jax.grad`` of the RGB MSE against ``target`` (over the pixels
    outside ``mask``), plus with ``target_depth`` the inverse demo's
    depth term, at ``params``.  Eager by default: under jit XLA rewrites
    the f32 pixel grid's arithmetic and flips pixels at plane edges and
    silhouettes, which op-by-op evaluation (the port's) does not."""
    import jax
    import jax.numpy as jnp

    from solr_tpu.ops.render import render_sample

    keep = (jnp.ones(target.shape[:2], bool) if mask is None
            else ~jnp.asarray(mask))
    w = keep[..., None].astype(target.dtype)

    def loss(p):
        img, depth = render_sample(scene.with_params(p), cam, cfg)
        lo = jnp.sum(w * (img[..., :3] - target) ** 2) / (
            jnp.sum(keep) * 3)
        if target_depth is not None:
            both = (target_depth < 1e29) & (depth < 1e29) & keep
            dres = jnp.where(both, depth - target_depth, 0.0)
            lo = lo + INVERSE_DEPTH_WEIGHT * jnp.sum(dres ** 2) / jnp.sum(keep)
        return lo

    fn = jax.value_and_grad(loss)
    return (jax.jit(fn) if jit else fn)(params)


def reference_inverse_case(cfg, f64=False):
    """The inverse-scene gradient case: the true scene against
    GRAD_TARGET_SCALE times its own image, plus the demo's depth term
    against the depth of its perturbed start (a gradient on every
    leaf), over the pixels outside the silhouette mask.  Returns the
    scene, camera, RGB target, target depth, mask, loss and grads."""
    import jax
    import jax.numpy as jnp

    from solr_tpu.ops.render import render_sample

    scene, cam = reference_inverse_scene()
    if f64:
        scene, cam = jax.tree.map(
            lambda x: x.astype(jnp.float64)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, (scene, cam))
    img, _ = render_sample(scene, cam, cfg)
    _, start_depth = render_sample(
        scene.with_params(inverse_start(scene.params)), cam, cfg)
    target = img[..., :3] * GRAD_TARGET_SCALE
    mask = silhouette_mask(scene, cam, cfg)
    loss, grads = reference_grads(scene, cam, cfg, scene.params, target,
                                  start_depth, mask)
    return dict(scene=scene, cam=cam, target=target, depth=start_depth,
                mask=mask, loss=loss, grads=grads)


def _sparse_rows(g):
    """(indices, rows) of the non-zero rows of an (N, 3) gradient."""
    g = np.asarray(g)
    idx = np.nonzero(np.abs(g).sum(-1) > 0.0)[0].astype(np.int32)
    return idx, g[idx].astype(np.float32)


def _grad_entries(prefix, grads):
    out = {}
    for k, v in grads.items():
        if k == "vertices":
            for i, vi in enumerate(v):
                idx, rows = _sparse_rows(vi)
                out[f"{prefix}_v{i}_idx"] = idx
                out[f"{prefix}_v{i}_rows"] = rows
        else:
            out[f"{prefix}_{k}"] = np.asarray(v, np.float32)
    return out


def write_grad_ref():
    """The three gradient cases ``chip_smoke.py``'s grad_reference phase
    holds the card to."""
    _setup(REF_BLOCK)
    import jax

    from solr_tpu_torch.bench_scene import bench_scene_arrays

    import solr_tpu as st
    from solr_tpu.ops.render import render_sample

    out = {}
    cfg = st.RenderConfig(width=GRAD_INVERSE_SIZE, height=GRAD_INVERSE_SIZE,
                          max_bounces=2)
    case = reference_inverse_case(cfg)
    mask = case["mask"]
    out.update(_grad_entries("inverse", case["grads"]), inverse_mask=mask,
               inverse_loss=np.float64(case["loss"]))
    arrays = bench_scene_arrays(REF_TRIS)
    for name, height in (("bench", REF_SIZE), ("walk", WALK_HEIGHT)):
        scene, cam, cfg = reference_bench_scene(arrays, REF_SIZE, height,
                                                REF_BOUNCES)
        img, _ = jax.jit(render_sample, static_argnums=2)(scene, cam, cfg)
        target = jax.lax.stop_gradient(img[..., :3]) * GRAD_TARGET_SCALE
        loss, g = reference_grads(scene, cam, cfg, scene.params, target,
                                  jit=True)
        out.update(_grad_entries(name, g))
        out[f"{name}_loss"] = np.float64(loss)
        out[f"{name}_height"] = np.int32(height)
        out[f"{name}_target"] = np.asarray(target, np.float32)
        print(f"{name}: loss {float(loss)!r}, "
              f"{len(out[f'{name}_v0_idx'])} vertex rows")
    np.savez_compressed(
        GRAD_REF_FILE, n_tris=REF_TRIS, size=REF_SIZE, block=REF_BLOCK,
        bounces=REF_BOUNCES, inverse_size=GRAD_INVERSE_SIZE,
        silhouette_rel=SILHOUETTE_REL, target_scale=GRAD_TARGET_SCALE,
        jax_version=jax.__version__, **out)
    print(f"wrote {GRAD_REF_FILE}: inverse mask {int(mask.sum())} of "
          f"{mask.size} pixels")


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


def reference_full_render(scene, cam, cfg, key=None, spp=1, jit=True):
    """``solr_tpu.render`` (samples and post-processing), jitted or
    (``jit=False``) op by op with every ``lax`` loop unrolled; the image
    as numpy."""
    import jax

    from solr_tpu.ops.render import render

    if not jit:
        with jax.disable_jit():
            return np.asarray(render(scene, cam, cfg, key, spp), np.float32)
    img = jax.jit(render, static_argnames=("cfg", "spp"))(
        scene, cam, cfg, key, spp=spp)
    return np.asarray(img, np.float32)


def write_stereo_ref():
    _setup(REF_BLOCK)
    from solr_tpu_torch.bench_scene import bench_scene_arrays

    scene, cam, cfg = reference_bench_scene(bench_scene_arrays(REF_TRIS),
                                            REF_SIZE, REF_SIZE, REF_BOUNCES)
    cfg = stereo_config(cfg)
    _save(STEREO_REF_FILE, reference_render(scene, cam, cfg),
          n_tris=REF_TRIS, width=cfg.width, height=cfg.height,
          tile_w=cfg.packet_tile_w, tile_h=cfg.packet_tile_h,
          block=REF_BLOCK, bounces=REF_BOUNCES)


def write_anaglyph_ref():
    _setup(256)
    import solr_tpu as st
    from solr_tpu.scenes import make_scene

    demo = make_scene("anaglyph", seed=0)
    cfg = dataclasses.replace(demo.default_config, width=CORNELL_SIZE,
                              height=CORNELL_SIZE,
                              max_bounces=CORNELL_BOUNCES)
    assert cfg.camera_mode == st.CameraMode.ANAGLYPH
    _save(ANAGLYPH_REF_FILE, reference_render(demo.scene, demo.camera, cfg),
          size=CORNELL_SIZE, bounces=CORNELL_BOUNCES)


def write_textured_ref():
    _setup(TEXTURED_BLOCK)
    import jax

    import solr_tpu as st
    from solr_tpu_torch.textured_scene import textured_scene_parts

    # Rendered op by op: under jit, XLA contracts the texture and bump
    # arithmetic into FMAs and moves 0.7% of the 64x64 frame's pixels
    # by up to 6.4e-4 from the reference's own op-by-op frame (ROADMAP
    # C1), which the port matches to 1.3e-5.
    parts = textured_scene_parts()
    scene, cam, cfg = reference_textured_scene(
        parts, TEXTURED_SIZE, TEXTURED_SIZE, TEXTURED_BOUNCES)
    out = {"image": reference_full_render(scene, cam, cfg, jit=False)}
    fish = dataclasses.replace(cfg, camera_mode=st.CameraMode.FISHEYE)
    out["image_fisheye"] = reference_full_render(scene, cam, fish, jit=False)
    lens = cam.replace(aperture=jax.numpy.float32(TEXTURED_APERTURE),
                       focal_distance=jax.numpy.float32(TEXTURED_FOCAL))
    dof = dataclasses.replace(cfg, postfx=st.types.PostFxConfig(
        mode=st.types.PostFxMode.DEPTH_OF_FIELD))
    out["image_dof"] = reference_full_render(scene, lens, dof, jit=False)
    for k, img in out.items():
        assert np.isfinite(img).all()
        print(f"{k}: digest {float(img.sum())!r}")
    np.savez_compressed(TEXTURED_REF_FILE, size=TEXTURED_SIZE,
                        bounces=TEXTURED_BOUNCES, block=TEXTURED_BLOCK,
                        aperture=TEXTURED_APERTURE, focal=TEXTURED_FOCAL,
                        jax_version=jax.__version__, **out)
    print(f"wrote {TEXTURED_REF_FILE}")


FRAMES = {
    "bench": write_bench_ref,
    "molecule": write_molecule_ref,
    "walk": lambda: write_bench_ref(WALK_HEIGHT, WALK_REF_FILE),
    "molecule_while": lambda: write_molecule_ref("while", MOL_WHILE_REF_FILE),
    "cornell": write_cornell_ref,
    "grads": write_grad_ref,
    "stereo": write_stereo_ref,
    "anaglyph": write_anaglyph_ref,
    "textured": write_textured_ref,
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
