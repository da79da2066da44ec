"""Inverse rendering through the port (BASELINE config #4): recovery by
Adam through ``render_sample`` (tests/test_gradients.py's
TestInverseRendering), the training utilities (tests/test_utils.py's
TestMetrics and TestCheckpoint, with a ``torch.Generator`` state where
the reference keeps a JAX key), and ``python -m solr_tpu_torch.inverse``
with checkpoint resume.  Everything here runs the port alone."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solr_tpu as st

from scenes_fixtures import cornell_box
from solr_tpu_torch.inverse import CLIP_NORM
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import Camera, PlaneAxis, RenderConfig
from test_torch_gradients import port_camera, port_scene

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _adam_steps(loss, start, groups, opt, steps, clip=None):
    """Run ``steps`` optimizer steps on the ``groups`` of ``start``, the
    gradient clipped to norm ``clip`` when given; returns the params
    (the other leaves stay constant)."""
    p = {k: v.detach().clone().requires_grad_(k in groups)
         if isinstance(v, torch.Tensor) else v for k, v in start.items()}
    trained = [p[k] for k in groups]
    opt = opt(trained)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss(p).backward()
        if clip is not None:
            torch.nn.utils.clip_grad_norm_(trained, clip)
        opt.step()
    return p


def test_recover_albedo():
    """Albedo-only perturbation of the f64 Cornell scene: the loss falls
    below 0.15x in 150 Adam steps at 32x32."""
    jscene = cornell_box(n_spheres=3, reflective=True, transparent=True,
                         seed=11, dtype=np.float64).build()
    jcam = st.Camera.create(position=(0.0, 0.0, -1.6), fov=1.1,
                            dtype=jnp.float64)
    scene = port_scene(jscene, torch.float64)
    cam = port_camera(jcam, torch.float64)
    cfg = RenderConfig(width=32, height=32, max_bounces=2)
    with torch.no_grad():
        target = render_sample(scene, cam, cfg)[0][..., :3]
    start = dict(scene.params)
    albedo = start["albedo"].clone()
    albedo[1:, :3] += 0.15
    start["albedo"] = albedo

    def loss(p):
        img, _ = render_sample(scene.with_params(p), cam, cfg)
        return ((img[..., :3] - target) ** 2).mean()

    with torch.no_grad():
        l0 = float(loss(start))
    p = _adam_steps(loss, start, ["albedo"],
                    lambda x: torch.optim.Adam(x, lr=2e-2), 150)
    with torch.no_grad():
        l1 = float(loss(p))
    assert np.isfinite(l1)
    assert l1 < l0 * 0.15, f"loss {l0:.3e} -> {l1:.3e}"


def test_recover_sphere_geometry():
    """Perturbed sphere centres and radii recovered from the RGB-D
    objective: the error falls at least 5x in 150 clipped Adam steps."""
    b = SceneBuilder()
    floor = b.add_material(color=(0.75, 0.75, 0.75, 1.0))
    red = b.add_material(color=(0.85, 0.25, 0.2, 1.0), specular=0.4)
    teal = b.add_material(color=(0.15, 0.6, 0.65, 1.0), specular=0.6)
    b.add_plane(PlaneAxis.XZ, (0.0, -1.0, 0.0), (12.0, 12.0), floor)
    b.add_sphere((-1.1, 0.0, 0.8), 1.0, red)
    b.add_sphere((1.2, -0.3, 0.0), 0.7, teal)
    b.add_light((3.0, 6.0, -4.0), intensity=1.0)
    scene = b.build(device="cpu")
    cam = Camera.create(position=(0.0, 1.2, -5.0), angles=(0.18, 0.0, 0.0),
                        fov=1.0, device="cpu")
    cfg = RenderConfig(width=32, height=32, max_bounces=2)
    with torch.no_grad():
        timg, tdepth = render_sample(scene, cam, cfg)
    timg = timg[..., :3]
    true_p = scene.params
    start = dict(true_p)
    center = true_p["sphere_center"].clone()
    center[0:2] += torch.tensor([[0.15, -0.12, 0.1], [-0.12, 0.1, -0.08]])
    radius = true_p["sphere_radius"].clone()
    radius[0:2] *= torch.tensor([1.12, 0.9])
    start.update(sphere_center=center, sphere_radius=radius)

    def loss(p):
        img, depth = render_sample(scene.with_params(p), cam, cfg)
        both = (tdepth < 1e29) & (depth < 1e29)
        dres = torch.where(both, depth - tdepth, torch.zeros_like(depth))
        return ((img[..., :3] - timg) ** 2).mean() + 0.05 * (dres ** 2).mean()

    def err(p):
        return max(
            float((p["sphere_center"][0:2]
                   - true_p["sphere_center"][0:2]).abs().max()),
            float((p["sphere_radius"][0:2]
                   - true_p["sphere_radius"][0:2]).abs().max()))

    e0 = err(start)
    p = _adam_steps(loss, start, ["sphere_center", "sphere_radius"],
                    lambda x: torch.optim.Adam(x, lr=1e-2), 150, CLIP_NORM)
    e1 = err(p)
    assert e1 < e0 / 5.0, f"geometry error {e0:.4f} -> {e1:.4f}"


# --------------------------------------------------------------------------
# Metrics (tests/test_utils.py:22-51)
# --------------------------------------------------------------------------


def test_utils_package_imports():
    import solr_tpu_torch.utils as u

    for name in u.__all__:
        assert getattr(u, name) is not None


def test_jsonl_logging(tmp_path):
    from solr_tpu_torch.utils import MetricsLogger

    p = str(tmp_path / "run.jsonl")
    with MetricsLogger(p) as m:
        m.log(rays_per_s=1.5e8, live_occupancy=0.5)
        m.log(step=7, loss=torch.tensor(0.25), grad=torch.ones(2))
    lines = [json.loads(s) for s in open(p)]
    assert lines[0]["step"] == 0 and lines[0]["rays_per_s"] == 1.5e8
    assert lines[1]["step"] == 7 and lines[1]["loss"] == 0.25
    assert lines[1]["grad"] == [1.0, 1.0]


def test_rays_meter():
    from solr_tpu_torch.utils import RaysMeter

    meter = RaysMeter()
    assert meter.tick(1000) is None  # the first tick has no interval
    rate = meter.tick(1000)
    assert rate is not None and rate > 0
    assert meter.total_rays == 2000


def test_grad_norms_and_occupancy():
    from solr_tpu_torch.utils import grad_norms, occupancy

    g = {"a": torch.ones(4), "b": (torch.zeros(2, 2),)}
    norms = grad_norms(g)
    assert norms == {"a": 2.0, "b/0": 0.0}
    assert occupancy(torch.tensor([True, False, True, False])) == 0.5
    assert occupancy(np.array([True, True])) == 1.0


# --------------------------------------------------------------------------
# Checkpoints (tests/test_utils.py:79-160)
# --------------------------------------------------------------------------


def _state(it=0):
    from solr_tpu_torch.utils import RenderState

    return RenderState(
        params={"c": torch.arange(3.0), "r": torch.tensor(2.0)},
        opt_state=(torch.zeros(3),),
        rng_state=torch.Generator().manual_seed(it).get_state(),
        accum=torch.ones(4, 4, 4) * it,
        iteration=it,
    )


def test_checkpoint_roundtrip(tmp_path):
    from solr_tpu_torch.utils import restore_render_state, save_render_state

    s = _state(3)
    p = str(tmp_path / "ck.npz")
    save_render_state(p, s)
    r = restore_render_state(p, _state(0))
    assert r.iteration == 3 and isinstance(r.iteration, int)
    assert torch.equal(r.accum, s.accum) and r.accum.dtype == torch.float32
    assert torch.equal(r.rng_state, s.rng_state)
    assert torch.equal(r.params["c"], s.params["c"])
    with np.load(p, allow_pickle=False) as data:  # no pickled object inside
        assert "params/r" in data.files


def test_checkpoint_structure_mismatch_raises(tmp_path):
    from solr_tpu_torch.utils import (RenderState, restore_render_state,
                                      save_render_state)

    p = str(tmp_path / "ck.npz")
    save_render_state(p, _state(1))
    fewer = _state(0).params.copy()
    del fewer["r"]
    with pytest.raises(KeyError, match="not in the template"):
        restore_render_state(p, RenderState(
            params=fewer, opt_state=(torch.zeros(3),), rng_state=None,
            accum=torch.ones(4, 4, 4), iteration=0))
    more = {**_state(0).params, "extra": torch.zeros(1)}
    with pytest.raises(KeyError, match="missing leaf"):
        restore_render_state(p, _state(0).__class__(
            params=more, opt_state=(torch.zeros(3),),
            rng_state=_state(0).rng_state, accum=torch.ones(4, 4, 4),
            iteration=0))


def test_checkpoint_manager_rotation_and_latest(tmp_path):
    from solr_tpu_torch.utils import CheckpointManager, latest_step

    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for step in (1, 5, 9):
        mgr.save(step, _state(step))
    assert latest_step(str(tmp_path)) == 9
    assert not os.path.exists(mgr.path(1))  # pruned
    assert os.path.exists(mgr.path(5))
    restored, step = mgr.restore(_state(0))
    assert step == 9 and restored.iteration == 9


def test_checkpoint_manager_empty_dir(tmp_path):
    from solr_tpu_torch.utils import CheckpointManager, latest_step

    mgr = CheckpointManager(str(tmp_path / "fresh"))
    template = _state(0)
    state, step = mgr.restore(template)
    assert step is None and state is template
    assert latest_step(str(tmp_path / "absent")) is None


def test_resume_continues_bitwise(tmp_path):
    """An interrupted run resumes bitwise: params, an Adam state and a
    generator drawn from on every step."""
    from solr_tpu_torch.utils import CheckpointManager, RenderState

    def fresh():
        c = torch.arange(3.0, requires_grad=True)
        return c, torch.optim.Adam([c], lr=0.1)

    def opt_step(c, opt, gen):
        noise = torch.randn(c.shape, generator=gen)
        opt.zero_grad()
        ((c - noise) ** 2).sum().backward()
        opt.step()

    def state(c, opt, gen, it):
        return RenderState(params={"c": c}, opt_state=opt.state_dict(),
                           rng_state=gen.get_state(), accum=None,
                           iteration=it)

    c, opt = fresh()
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        opt_step(c, opt, gen)

    c2, opt2 = fresh()
    gen2 = torch.Generator().manual_seed(0)
    for _ in range(2):
        opt_step(c2, opt2, gen2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state(c2, opt2, gen2, 2))

    c3, opt3 = fresh()
    opt_step(c3, opt3, torch.Generator().manual_seed(1))  # fill Adam's state
    gen3 = torch.Generator()
    restored, at = mgr.restore(state(c3, opt3, gen3, 0))
    assert at == 2 and restored.iteration == 2
    with torch.no_grad():
        c3.copy_(restored.params["c"])
    opt3.load_state_dict(restored.opt_state)
    gen3.set_state(restored.rng_state)
    for _ in range(2):
        opt_step(c3, opt3, gen3)
    assert torch.equal(c3, c)
    assert torch.equal(gen3.get_state(), gen.get_state())


# --------------------------------------------------------------------------
# The demo: python -m solr_tpu_torch.inverse
# --------------------------------------------------------------------------


def _run_inverse(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = str(tmp_path)
    os.makedirs(out, exist_ok=True)
    return subprocess.run(
        [sys.executable, "-m", "solr_tpu_torch.inverse", "--device", "cpu",
         "--size", "16", "--ckpt-dir", os.path.join(out, "ckpt"),
         "--metrics", os.path.join(out, "metrics.jsonl"),
         "--out", os.path.join(out, "inverse.png"), *args],
        cwd=out, env=env, capture_output=True, text=True, timeout=300)


def test_inverse_demo_runs_and_resumes(tmp_path):
    """Three steps (too few for the 20x bar, so the run exits 1 and says
    so), then ``--resume`` to 60: it continues from step 3 and meets the
    bar; its steps 3-5 equal those of one uninterrupted run."""
    first = _run_inverse(tmp_path / "a", "--steps", "3")
    assert first.returncode == 1, first.stderr
    assert "failed to converge 20x" in first.stderr
    assert os.path.exists(tmp_path / "a" / "ckpt" / "ckpt_3.npz")
    with open(tmp_path / "a" / "inverse.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"

    resumed = _run_inverse(tmp_path / "a", "--steps", "60", "--resume")
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed from step 3" in resumed.stdout
    straight = _run_inverse(tmp_path / "b", "--steps", "6")

    def records(d):
        with open(d / "metrics.jsonl") as f:
            return [json.loads(s) for s in f]

    a, b = records(tmp_path / "a"), records(tmp_path / "b")
    assert [r["step"] for r in a] == list(range(60))
    for k in (3, 4, 5):
        assert a[k]["loss"] == b[k]["loss"]
        assert a[k]["albedo_err"] == b[k]["albedo_err"]
