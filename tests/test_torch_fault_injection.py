"""The port's kill-one-host harness (solr_tpu_torch.fault_injection)
against tools/fault_injection.py: the same scene, and the harness end to
end on the CPU."""

import json
import os
import subprocess
import sys

import solr_tpu as st

from solr_tpu_torch.fault_injection import fault_scene
from torch_scene_helpers import assert_same_camera, assert_same_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_build():
    """tools/fault_injection.py's _build (the tool imports JAX and pins
    its platform at import, so its scene is rebuilt here)."""
    b = st.SceneBuilder()
    m = b.add_material(color=(0.7, 0.4, 0.2, 1.0), specular=0.3)
    mirror = b.add_material(color=(0.9, 0.9, 0.9, 1.0), reflection=0.5)
    floor = b.add_material(color=(0.5, 0.5, 0.55, 1.0))
    b.add_plane(st.types.PlaneAxis.XZ, (0.0, -1.0, 0.0), (10.0, 10.0),
                floor)
    for i in range(5):
        b.add_sphere((i - 2.0, 0.0, 2.0 + (i % 2)), 0.5,
                     m if i % 2 else mirror)
    b.add_light((0.0, 6.0, -2.0), intensity=1.0)
    cam = st.Camera.create(position=(0.0, 0.8, -4.0),
                           angles=(0.15, 0.0, 0.0), fov=1.0)
    return b.build(), cam, st.RenderConfig(width=48, height=48, max_bounces=2)


def test_fault_scene_equals_reference():
    scene, cam, cfg = fault_scene(48, device="cpu")
    jscene, jcam, jcfg = _reference_build()
    assert_same_scene(scene, jscene)
    assert_same_camera(cam, jcam)
    assert (cfg.width, cfg.height, cfg.max_bounces) == (
        jcfg.width, jcfg.height, jcfg.max_bounces)


def test_harness_end_to_end_on_cpu():
    """Host 1 is SIGKILLed after its first heartbeat, detected stalled,
    relaunched and resumed from its checkpoint: exit 0, a frame
    bit-identical to the uninterrupted run, no finished chunk rendered
    again, and equal to the one-shot frame."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "solr_tpu_torch.fault_injection",
         "--device", "cpu", "--res", "32"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["fault_injection_ok"] and rec["bit_identical_to_uninterrupted"]
    assert rec["work_preserved"], rec
    assert rec["resumed_from_chunk"] > 0 and rec["chunks_rendered_again"] == 0
    assert rec["chunks_per_host"] == 2 and rec["killed_host"] == 1
    assert rec["detect_s"] > 0
    assert rec["pixels_differing_from_one_shot"] == 0, rec
