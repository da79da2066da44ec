"""The port's Engine, viewer CLI and profiling scopes against solr_tpu's.

* Engine: ``test_engine_frame_morphing``'s assertions (tests/
  test_scenes.py), and two morphed frames walked through their BVHs on
  the same Engine, each equal to the frame of the same morph of freshly
  built scenes: nothing derived from one frame's tensors (the walk
  order's leaf-box check, the kernels' packed rows) may serve the next.
* Viewer: ``--list`` against the reference's; stills, files, modes,
  animation, metrics; a progressive render with ``JaxKey`` (tests/
  torch_rng_helpers.py) against the reference viewer's accumulator
  (atol 1e-4 outside 0.2% of pixels, ROADMAP C1); a row-band still
  against the one-shot one; a checkpointed progressive render resumed
  bit-equal to an uninterrupted one; a default-device call without a
  card raises.
* Profiling: ``render_phase`` is a named span (``solr/<name>``) of an
  active profiler session and ``trace`` writes it into a Chrome trace.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops.render import accumulate as ref_accumulate
from solr_tpu.ops.render import jit_render
from solr_tpu.scenes import make_scene as ref_make_scene
from solr_tpu.viewer import main as ref_main

from torch_rng_helpers import JaxKey
from torch_scene_helpers import assert_image_close
from solr_tpu_torch import Engine, Key, RenderConfig, SceneBuilder, render
from solr_tpu_torch.engine import morph_scenes
from solr_tpu_torch.io import load_image
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.utils import render_phase, trace
from solr_tpu_torch.viewer import _parser, main, run

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)


def _viewer(tmp_path, *flags, key=None):
    """The port's viewer on the CPU; returns its image."""
    argv = ["--device", "cpu", "--width", "16", "--height", "16",
            "--bounces", "2", *flags]
    if "--out" not in flags:
        argv += ["--out", str(tmp_path / "out.png")]
    args = _parser().parse_args(argv)
    return run(args, Key.seed(args.seed, "cpu") if key is None else key)


# -- Engine ------------------------------------------------------------

def _sphere_scene(z):
    b = SceneBuilder()
    m = b.add_material(color=(0.8, 0.3, 0.2, 1))
    b.add_sphere((0, 0, z), 1.0, m)
    b.add_light((3, 6, -3))
    return b.build(device="cpu")


def test_engine_frame_morphing():
    a, b = _sphere_scene(2.0), _sphere_scene(5.0)
    eng = Engine(config=RenderConfig(width=16, height=16, max_bounces=1),
                 device="cpu")
    eng.set_nb_frames(4)
    eng.set_keyframes(a, b)
    zs = [float(eng.next_frame().spheres.center[0, 2]) for _ in range(4)]
    assert zs == [3.0, 4.0, 5.0, 2.0]  # lerp, then back to frame 0
    mid = morph_scenes(a, b, 0.5)
    assert float(mid.spheres.center[0, 2]) == 3.5
    assert mid.spheres.material.dtype == a.spheres.material.dtype
    assert mid.tri_bvh is None and mid.spheres.material is a.spheres.material
    with torch.no_grad():
        img = render(mid, eng.camera, eng.config)
    assert torch.isfinite(img).all()


def _field(shift):
    """A triangle mesh, spheres and cylinders, each pool past the BVH
    threshold, moved by ``shift``."""
    rng = np.random.default_rng(3)
    b = SceneBuilder()
    m = b.add_material(color=(0.7, 0.6, 0.5, 1.0), specular=0.3)
    c = rng.uniform(-2, 2, (80, 3)) + (0.0, 0.0, 4.0) + shift
    b.add_triangles_raw(c, c + rng.normal(0, 0.3, (80, 3)),
                        c + rng.normal(0, 0.3, (80, 3)), m)
    for p in rng.uniform(-2, 2, (70, 3)) + (0.0, 0.0, 4.0) + shift:
        b.add_sphere(tuple(p), 0.12, m)
        b.add_cylinder(tuple(p), tuple(p + (0.3, 0.2, 0.0)), 0.05, m)
    b.add_light((3.0, 6.0, -3.0))
    return b.build(device="cpu")


def test_engine_morphed_frames_take_no_stale_derived_state():
    cfg = RenderConfig(width=24, height=24, max_bounces=2,
                       traversal="while")
    eng = Engine(config=cfg, device="cpu")
    eng.set_nb_frames(3)
    eng.set_keyframes(_field(0.0), _field(np.array([0.4, -0.3, 0.5])))
    for t in (0.5, 1.0):
        scene = eng.next_frame()
        assert scene.tri_bvh is not None and scene.cyl_bvh is not None
        with torch.no_grad():
            got, _ = render_sample(scene, eng.camera, cfg)
            fresh = morph_scenes(_field(0.0),
                                 _field(np.array([0.4, -0.3, 0.5])), t)
            want, _ = render_sample(fresh, eng.camera, cfg)
        assert torch.equal(got, want)
        del scene


def test_engine_progressive_frames():
    eng = Engine(config=RenderConfig(width=16, height=16, max_bounces=1,
                                     antialias_jitter=True), device="cpu")
    m = eng.add_material(color=(0.2, 0.8, 0.3, 1.0))
    eng.add_sphere((0, 0, 2.0), 1.0, m)
    eng.add_light((3, 6, -3))
    first = eng.render_frame()
    second = eng.render_frame()
    assert first.shape == (16, 16, 4) and not np.array_equal(first, second)
    assert eng.bitmap().dtype == np.uint8


# -- viewer ------------------------------------------------------------

def test_list_matches_reference(capsys):
    ref_main(["--list"])
    ref = capsys.readouterr().out.split()
    main(["--list"])
    assert capsys.readouterr().out.split() == ref
    assert len(ref) == 22


def test_still_writes_png(tmp_path):
    out = str(tmp_path / "c.png")
    main(["--scene", "cornell", "--out", out, "--width", "32", "--height",
          "32", "--bounces", "1", "--device", "cpu"])
    assert load_image(out).shape == (32, 32, 4)


def test_default_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        main(["--scene", "cornell", "--width", "8", "--height", "8",
              "--out", str(tmp_path / "x.png")])


def test_progressive_matches_reference_viewer(tmp_path):
    """``--spp 4`` with the reference's keys: the reference viewer's
    accumulation loop (solr_tpu/viewer.py _progressive), replayed."""
    seed, spp = 3, 4
    img = _viewer(tmp_path, "--scene", "cornell", "--spp", str(spp),
                  "--seed", str(seed), key=JaxKey(seed))
    demo = ref_make_scene("cornell", seed=seed)
    cfg = st.RenderConfig(width=16, height=16, max_bounces=2,
                          antialias_jitter=True)
    key = jax.random.PRNGKey(seed)
    accum = np.zeros((16, 16, 4), np.float32)
    for it in range(spp):
        key, sub = jax.random.split(key)
        accum = ref_accumulate(accum, jit_render(demo.scene, demo.camera,
                                                 cfg, sub), it)
    assert_image_close(img, np.asarray(accum))
    assert load_image(str(tmp_path / "out.png")).shape == (16, 16, 4)


def test_resumed_progressive_is_bit_equal(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    whole = _viewer(tmp_path, "--scene", "cornell", "--spp", "8")
    _viewer(tmp_path, "--scene", "cornell", "--spp", "4",
            "--checkpoint-dir", ck, "--checkpoint-every", "4")
    capsys.readouterr()
    resumed = _viewer(tmp_path, "--scene", "cornell", "--spp", "8",
                      "--checkpoint-dir", ck, "--resume")
    assert "resumed progressive render at sample 4" in capsys.readouterr().out
    np.testing.assert_array_equal(resumed, whole)
    with pytest.raises(TypeError):
        _viewer(tmp_path, "--scene", "cornell", "--spp", "2",
                "--checkpoint-dir", ck, key=JaxKey(0))


def test_row_band_still_matches_one_shot(tmp_path):
    out = str(tmp_path / "bands.png")
    bands = _viewer(tmp_path, "--scene", "terrain", "--width", "32",
                    "--height", "32", "--tile-rows", "16", "--out", out)
    still = _viewer(tmp_path, "--scene", "terrain", "--width", "32",
                    "--height", "32")
    assert_image_close(bands, still)
    assert not os.path.exists(out + ".ckpt")  # a derived directory goes
    kept = str(tmp_path / "kept")
    again = _viewer(tmp_path, "--scene", "terrain", "--width", "32",
                    "--height", "32", "--tile-rows", "16",
                    "--checkpoint-dir", kept)
    np.testing.assert_array_equal(again, bands)
    assert os.listdir(kept)


@pytest.mark.parametrize("flags", [
    ["--mode", "anaglyph"], ["--mode", "sidebyside"], ["--mode", "fisheye"],
    ["--postfx", "dof"], ["--postfx", "ao"]], ids=lambda f: f[1])
def test_modes_render(tmp_path, flags):
    img = _viewer(tmp_path, "--scene", "cornell", *flags)
    assert np.isfinite(img).all() and img[..., :3].std() > 1e-3


def test_animation_and_metrics(tmp_path):
    out, log = str(tmp_path / "anim"), str(tmp_path / "m.jsonl")
    _viewer(tmp_path, "--scene", "cubes", "--frames", "3", "--out", out,
            "--metrics", log)
    frames = [load_image(os.path.join(out, f"frame_{f:04d}.png"))
              for f in range(3)]
    assert not np.array_equal(frames[0], frames[2])
    lines = [json.loads(x) for x in open(log)]
    assert [x["frame"] for x in lines] == [0, 1, 2]


def test_files_and_irt(tmp_path, capsys):
    (tmp_path / "n.swc").write_text(
        "1 1 0 0 0 2 -1\n2 3 5 0 0 1 1\n3 3 10 2 0 0.8 2\n")
    (tmp_path / "t.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\nf 1 2 3 4\n")
    (tmp_path / "m.pdb").write_text(
        "ATOM      1  C   ALA A   1       0.000   0.000   0.000  1.00  0.00"
        "           C\nATOM      2  O   ALA A   1       1.200   0.000   0.000"
        "  1.00  0.00           O\nEND\n")
    for name in ("n.swc", "t.obj", "m.pdb"):
        img = _viewer(tmp_path, "--file", str(tmp_path / name))
        assert np.isfinite(img).all() and img[..., :3].std() > 1e-3
    assert "built the scene in" in capsys.readouterr().out
    irt = str(tmp_path / "terrain.irt")
    original = _viewer(tmp_path, "--scene", "terrain", "--save-irt", irt)
    loaded = _viewer(tmp_path, "--file", irt)
    np.testing.assert_allclose(loaded, original, atol=1e-6)


# -- profiling ---------------------------------------------------------

def test_profiling_scopes(tmp_path):
    x = torch.ones(64)
    with trace(str(tmp_path / "tr")) as prof:
        with render_phase("traverse"):
            (x * 2).sum()
    names = {e.key for e in prof.key_averages()}
    assert "solr/traverse" in names
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "solr/traverse" in open(tmp_path / "tr" / files[0]).read()
