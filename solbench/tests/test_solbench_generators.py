"""The frozen generators equal the program's at the same seeds, and the
configurations state what the program's bench and molecule frames
use."""

import numpy as np
import pytest

from solbench import manifest
from solbench.scenes import molecule, terrain


@pytest.mark.parametrize("n_tris,seed", [(2000, 42), (2000, 7),
                                         (1_000_000, 2**31 + 5)])
def test_terrain_arrays_equal_bench_scene_arrays(n_tris, seed):
    from solr_tpu_torch.bench_scene import bench_scene_arrays

    got = terrain.bench_arrays(n_tris, 40.0, 24, seed)
    want = bench_scene_arrays(n_tris, seed)
    for k in ("vertices", "faces", "sphere_centers", "sphere_radii"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_terrain_inputs_are_the_bench_spheres_in_seeded_order(seed):
    cfg = dict(manifest.Cell("terrain1m.auto").config, n_tris=2000)
    got = terrain.make_inputs(cfg, seed)
    want = terrain.bench_arrays(2000, cfg["extent"], cfg["n_spheres"],
                                cfg["sphere_seed"])
    np.testing.assert_array_equal(got["vertices"], want["vertices"])
    np.testing.assert_array_equal(got["faces"], want["faces"])
    order = np.argsort(got["sphere_radii"])
    np.testing.assert_array_equal(got["sphere_radii"][order],
                                  np.sort(want["sphere_radii"]))
    np.testing.assert_array_equal(
        got["sphere_centers"][order],
        want["sphere_centers"][np.argsort(want["sphere_radii"])])
    again = terrain.make_inputs(cfg, seed)
    np.testing.assert_array_equal(got["sphere_radii"], again["sphere_radii"])


def test_terrain_config_is_the_bench_frame():
    from solr_tpu_torch.bench_scene import bench_scene_arrays

    cfg = manifest.Cell("terrain1m.auto").config
    want = bench_scene_arrays(2000, 42)
    assert cfg["light"]["position"] == list(want["light_position"])
    assert cfg["light"]["intensity"] == want["light_intensity"]
    for name, key in (("terrain", "terrain_material"),
                      ("mirror", "mirror_material")):
        for k, v in want[key].items():
            assert cfg["materials"][name][k] == (list(v) if isinstance(
                v, tuple) else v)
    cam = {k: list(v) if isinstance(v, tuple) else v
           for k, v in want["camera"].items()}
    assert cfg["camera"] == cam
    assert cfg["gradient_background"] == want["config"]["gradient_background"]
    assert cfg["packet"] == {k: v for k, v in want["config"].items()
                             if k.startswith("packet")}
    assert cfg["bvh_threshold"] == want["bvh_threshold"]
    assert cfg["n_spheres"] == len(want["sphere_radii"])


@pytest.mark.parametrize("seed", [42, 3, 2**31 + 11])
def test_molecule_generator_equals_molecule_scene_parts(seed):
    from solr_tpu_torch.molecule_scene import molecule_scene_parts

    cfg = manifest.Cell("molecule100k.auto").config
    want = molecule_scene_parts(300, cfg["ground"]["res"], seed)
    assert molecule.synthetic_pdb(300, seed) == want["pdb"]
    assert cfg["molecule_radius"] / molecule.globule_radius(300) == \
        want["load"]["scale"]
    v, f = molecule.height_mesh(cfg["ground"]["res"], cfg["ground"]["extent"],
                                cfg["ground"]["z0"], cfg["ground"]["y"])
    np.testing.assert_array_equal(v, want["ground_vertices"])
    np.testing.assert_array_equal(f, want["ground_faces"])


@pytest.mark.parametrize("seed", [5, 2**31 + 11])
def test_molecule_inputs_are_the_molecule_in_seeded_order(seed):
    cfg = dict(manifest.Cell("molecule100k.auto").config, n_atoms=300)
    got = molecule.make_inputs(cfg, seed)
    want = molecule.synthetic_pdb(300, cfg["pdb_seed"]).splitlines()
    lines = got["pdb"].splitlines()
    assert lines[-1] == want[-1] == "END"
    assert sorted(lines) == sorted(want) and lines != want
    assert got["pdb"] == molecule.make_inputs(cfg, seed)["pdb"]


def test_molecule_config_is_the_molecule_frame():
    import inspect

    from solr_tpu_torch.io import pdb
    from solr_tpu_torch.molecule_scene import GROUND, MOLECULE_RADIUS, \
        molecule_scene_parts

    cfg = manifest.Cell("molecule100k.auto").config
    want = molecule_scene_parts(300, 128, 1)
    assert cfg["ground"] == {k: GROUND[k] for k in cfg["ground"]}
    assert cfg["molecule_radius"] == MOLECULE_RADIUS
    assert cfg["light"]["position"] == list(want["light_position"])
    assert cfg["camera"]["position"] == list(want["camera"]["position"])
    assert cfg["camera"]["fov"] == want["camera"]["fov"]
    for k, v in want["ground_material"].items():
        assert cfg["materials"]["ground"][k] == (list(v) if isinstance(
            v, tuple) else v)
    assert cfg["pdb"]["mode"] == want["load"]["mode"].name
    defaults = inspect.signature(pdb.load_pdb).parameters
    for k in ("atom_scale", "stick_radius", "bond_cutoff", "specular"):
        assert cfg["pdb"][k] == defaults[k].default
    assert cfg["packet"] == want["config"]


@pytest.mark.parametrize("name", ["terrain1m.auto", "molecule100k.auto"])
def test_config_info_is_scene_info_defaults(name):
    import inspect

    from solr_tpu_torch.types import SceneInfo

    params = inspect.signature(SceneInfo.create).parameters
    for k, v in manifest.Cell(name).config["info"].items():
        default = params[k].default
        assert v == (list(default) if isinstance(default, tuple) else default)
