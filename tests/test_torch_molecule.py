"""The molecule frame (solr_tpu_torch.molecule_scene, io/pdb.py) against
solr_tpu on the CPU: the synthetic PDB, the PDB loader, and a small
molecule frame through both packages' render_sample with all three pools
(spheres, cylinders, the ground's triangles) on the packet path.

Tolerances:
* the loader: spheres, cylinders, their order and the materials equal
  (the same float64 parse and bond test, then the same float32 cast);
* images: atol 1e-4 outside a budget of 0.2% of pixels, as for the
  bench frame (tests/test_torch_render.py).  Here the pixels outside are
  cylinder hits: the recomputed hit distance of a thin cylinder differs
  in its last bits (the reference contracts it into FMAs, ROADMAP C1),
  and the radial normal, point minus axis foot, magnifies that by
  |point| / radius.  Measured 7 of 4,096 pixels on the committed 64x64
  frame, all under 2.3e-4.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.io import load_pdb as j_load_pdb
from solr_tpu.io.pdb import GeometryMode as JMode
from solr_tpu.ops import packet as jpk

from data.torch_reference import (MOL_REF_FILE, numpy_tree, pdb_sha256,
                                  reference_molecule_scene, reference_render)
from solr_tpu_torch.convert import (camera_from_numpy,
                                    config_from_reference_fields,
                                    scene_from_numpy)
from solr_tpu_torch.io import GeometryMode, load_pdb
from solr_tpu_torch.io.pdb import _read_atoms
from solr_tpu_torch.molecule_scene import (BOND, globule_radius,
                                           molecule_scene,
                                           molecule_scene_parts,
                                           synthetic_pdb)
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.scene import SceneBuilder

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

ATOL = 1e-4
BUDGET = 0.002
N_ATOMS, GROUND_RES, SIZE = 600, 16, 32


def assert_image_close(img, ref):
    img = np.asarray(img)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    err = np.abs(img - ref).max(-1)
    frac = (err > ATOL).mean()
    assert frac <= BUDGET, f"{frac:.3%} of pixels differ by more than {ATOL}"


@pytest.fixture(scope="module")
def mol_ref(tmp_path_factory):
    """The small molecule frame built and rendered by solr_tpu."""
    parts = molecule_scene_parts(N_ATOMS, GROUND_RES)
    scene, cam, cfg = reference_molecule_scene(
        parts, SIZE, SIZE, 2, str(tmp_path_factory.mktemp("pdb")))
    return scene, cam, cfg, reference_render(scene, cam, cfg)


def test_synthetic_pdb_is_protein_like():
    text = synthetic_pdb(2_000, seed=7)
    assert text == synthetic_pdb(2_000, seed=7)
    assert text != synthetic_pdb(2_000, seed=8)
    pos, elements, backbone = _read_atoms(io.StringIO(text))
    assert pos.shape == (2_000, 3) and len(backbone) == 500
    assert elements[1::4] == ["C"] * 500  # every 4th atom a CA carbon
    share = {e: elements.count(e) / 2_000 for e in "CNOS"}
    for e, want in {"C": 0.63, "N": 0.17, "O": 0.19}.items():
        assert abs(share[e] - want) < 0.04, share
    bonds = np.linalg.norm(np.diff(pos, axis=0), axis=-1)
    np.testing.assert_allclose(bonds, BOND, atol=2e-3)  # 3-decimal columns
    r = np.linalg.norm(pos, axis=-1)  # the chain starts at the centre
    assert r.max() <= globule_radius(2_000) + BOND
    assert r.max() > 0.8 * globule_radius(2_000)  # the globule is filled


@pytest.mark.parametrize("mode", list(GeometryMode), ids=lambda m: m.name)
def test_load_pdb_matches_reference(tmp_path, mode):
    """The same spheres, cylinders, order and materials on a 2,000-atom
    synthetic PDB, both builders left in insertion order."""
    text = synthetic_pdb(2_000)
    path = tmp_path / "m.pdb"
    path.write_text(text)
    jb = st.SceneBuilder()
    n_ref = j_load_pdb(str(path), jb, mode=JMode(int(mode)), scale=0.125)
    tb = SceneBuilder()
    n_port = load_pdb(io.StringIO(text), tb, mode=mode, scale=0.125)
    assert n_port == n_ref == 2_000
    ref = jb.build(use_bvh=False)
    port = tb.build(bvh_threshold=10**9, device="cpu")
    fields = {"spheres": ("center", "radius", "material"),
              "cylinders": ("p0", "p1", "radius", "material"),
              "materials": ("color", "specular", "reflection", "ior",
                            "transparency", "emission", "procedural",
                            "procedural_scale")}
    for pool, names in fields.items():
        for f in names:
            a = np.asarray(getattr(getattr(ref, pool), f))
            b = getattr(getattr(port, pool), f).numpy()
            np.testing.assert_array_equal(b, a.astype(b.dtype),
                                          err_msg=f"{pool}.{f}")
    assert (port.cylinders.radius.shape[0] == 0) == (mode == GeometryMode.ATOMS)


def _packet_prims(monkeypatch):
    """Record the primitive kinds the sweep wrappers are called with."""
    seen = set()
    for entry in ("sweep_closest", "sweep_transmittance"):
        fn = getattr(sweep, entry)

        def spy(*args, _fn=fn, _entry=entry, **kw):
            seen.add((_entry, kw.get("prim", args[-1])))
            return _fn(*args, **kw)

        monkeypatch.setattr(sweep, entry, spy)
    return seen


def test_molecule_frame_matches_reference(mol_ref, monkeypatch):
    """The port's own builder and molecule scene, same PDB text."""
    jscene, *_, ref = mol_ref
    # The reference takes the packet path for every pool: the frame has a
    # triangle BVH (render.py:273) and the sphere and cylinder accels.
    assert jscene.tri_bvh is not None
    assert None not in (jscene.sph_accel, jscene.cyl_accel)
    scene, cam, cfg = molecule_scene(N_ATOMS, GROUND_RES, width=SIZE,
                                     height=SIZE, block=jpk.BLOCK,
                                     device="cpu")
    seen = _packet_prims(monkeypatch)
    img, _ = render_sample(scene, cam, cfg)
    assert seen == {(e, p) for e in ("sweep_closest", "sweep_transmittance")
                    for p in sweep.PRIMS}
    assert_image_close(img.numpy(), ref)


def test_converted_molecule_frame_matches_reference(mol_ref):
    """The reference's own scene, accelerators included, carried
    across."""
    jscene, jcam, jcfg, ref = mol_ref
    scene = scene_from_numpy(numpy_tree(jscene), "cpu")
    img, _ = render_sample(scene, camera_from_numpy(numpy_tree(jcam), "cpu"),
                           config_from_reference_fields(
                               dataclasses.asdict(jcfg)))
    assert_image_close(img.numpy(), ref)


def test_molecule_scene_pools():
    scene, _, cfg = molecule_scene(N_ATOMS, GROUND_RES, width=SIZE,
                                   height=SIZE, device="cpu")
    assert int((scene.spheres.radius > 0).sum()) == N_ATOMS + 1  # + light
    assert scene.triangles.v0.shape[0] == 2 * GROUND_RES ** 2
    n_cyl = int((scene.cylinders.radius > 0).sum())
    assert N_ATOMS < n_cyl < 4 * N_ATOMS  # chain bonds plus contacts
    for key in ("tri_accel", "sph_accel", "cyl_accel"):
        assert getattr(scene, key).block == 256
    # The light is the one emissive sphere; its shadow factor is 1 and
    # every atom's is 0.
    rows = scene.sph_accel.packed.transpose(0, 1).reshape(16, -1)
    real = rows[3] > 0
    assert rows[15][real].sum() == 1.0
    assert scene.lights.position.shape == (1, 3)
    assert cfg.packet_rays == 256 and cfg.max_bounces == 2


def test_committed_molecule_reference_frame():
    """The frame chip_smoke.py holds the card to, on the CPU."""
    ref = np.load(MOL_REF_FILE)
    n = int(ref["n_atoms"])
    assert pdb_sha256(synthetic_pdb(n)) == str(ref["pdb_sha256"])
    size = int(ref["size"])
    scene, cam, cfg = molecule_scene(n, int(ref["ground_res"]), width=size,
                                     height=size, bounces=int(ref["bounces"]),
                                     block=int(ref["block"]), device="cpu")
    assert_image_close(render_sample(scene, cam, cfg)[0].numpy(), ref["image"])
