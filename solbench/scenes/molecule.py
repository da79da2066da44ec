"""The molecule scene kind: a ball-and-stick molecule read from PDB text
over a reflective heightfield ground, one point light.

``make_inputs`` is a frozen copy of the program's seeded generator
(``solr_tpu_torch.molecule_scene.synthetic_pdb`` and the ground of
``molecule_scene_parts``): a protein-like chain of heavy atoms folded
into a globule, written as PDB ATOM records.  A test holds the copy
equal to the program's.  ``build_port`` hands the PDB text and the
ground to the system under test through ``load_pdb`` and
``SceneBuilder``.
"""

from __future__ import annotations

import io
import math

import numpy as np

BOND = 1.53  # angstroms, a C-C single bond
# cos and sin of 69 degrees, the turn between successive bonds at a bond
# angle of 111 degrees.
_COS_TURN = 0.35836794954530027
_SIN_TURN = 0.9335804264972017
DENSITY = 0.06  # heavy atoms per cubic angstrom in a folded protein
_TRIES = 8
_ELEMENTS = ("C", "N", "O", "S")
_CDF_NON_CA = np.cumsum([0.63 - 0.25, 0.17, 0.19, 0.01]) / 0.75


def globule_radius(n_atoms: int) -> float:
    """Radius in angstroms of a sphere that holds n_atoms at DENSITY,
    rounded to 1e-3."""
    return round((3.0 * n_atoms / (4.0 * math.pi * DENSITY)) ** (1.0 / 3.0), 3)


class _Uniform:
    """Uniform draws from one seeded stream, fetched in bulk."""

    def __init__(self, seed: int, chunk: int):
        self._rng = np.random.default_rng(seed)
        self._chunk = chunk
        self._buf = []

    def __call__(self) -> float:
        if not self._buf:
            self._buf = self._rng.random(self._chunk).tolist()[::-1]
        return self._buf.pop()


def _unit(x, y, z):
    n = math.sqrt(x * x + y * y + z * z)
    return x / n, y / n, z / n


def _chain(n: int, radius: float, draw) -> list:
    """A chain of n atoms inside a sphere of ``radius``: bond BOND, bond
    angle 111 degrees, random torsion; a step that would leave the
    sphere redraws its torsion up to _TRIES times, then heads for the
    centre."""
    r2 = radius * radius
    pts = [(0.0, 0.0, 0.0)]
    ux, uy, uz = _unit(draw() - 0.5, draw() - 0.5, draw() - 0.5)
    for _ in range(n - 1):
        cx, cy, cz = pts[-1]
        ax, ay, az = (1.0, 0.0, 0.0) if abs(ux) < 0.9 else (0.0, 1.0, 0.0)
        e1 = _unit(uy * az - uz * ay, uz * ax - ux * az, ux * ay - uy * ax)
        e2 = (uy * e1[2] - uz * e1[1], uz * e1[0] - ux * e1[2],
              ux * e1[1] - uy * e1[0])
        for _ in range(_TRIES):
            while True:
                a, b = 2.0 * draw() - 1.0, 2.0 * draw() - 1.0
                q = a * a + b * b
                if 1e-6 < q <= 1.0:
                    break
            s = _SIN_TURN / math.sqrt(q)
            vx = _COS_TURN * ux + s * (a * e1[0] + b * e2[0])
            vy = _COS_TURN * uy + s * (a * e1[1] + b * e2[1])
            vz = _COS_TURN * uz + s * (a * e1[2] + b * e2[2])
            px, py, pz = cx + BOND * vx, cy + BOND * vy, cz + BOND * vz
            if px * px + py * py + pz * pz <= r2:
                break
        else:
            vx, vy, vz = _unit(-cx, -cy, -cz)
            px, py, pz = cx + BOND * vx, cy + BOND * vy, cz + BOND * vz
        ux, uy, uz = _unit(vx, vy, vz)
        pts.append((px, py, pz))
    return pts


def synthetic_pdb(n_atoms: int, seed: int) -> str:
    """A protein-like PDB text of n_atoms heavy atoms (C/N/O/S at about
    63/17/19/1 %, every 4th atom a CA)."""
    draw = _Uniform(seed, 1 << 16)
    pts = _chain(n_atoms, globule_radius(n_atoms), draw)
    u = np.random.default_rng(seed + 1).random(n_atoms)
    kinds = np.searchsorted(_CDF_NON_CA, u, side="right").clip(0, 3)
    lines = []
    for i, (x, y, z) in enumerate(pts):
        ca = i % 4 == 1
        el = "C" if ca else _ELEMENTS[kinds[i]]
        name = "CA" if ca else el
        lines.append(
            f"ATOM  {(i + 1) % 100000:5d}  {name:<3s} GLY A{(i // 4 + 1) % 10000:4d}"
            f"    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {el:>2s}  ")
    lines.append("END")
    return "\n".join(lines) + "\n"


def height_mesh(res: int, extent: float, z0: float, y: float):
    """The ground: y + 0.3 sin(0.45 x) cos(0.35 z) + 0.1 sin(1.3 x + 0.5)
    sin(1.1 z) over x in [-extent, extent], z in [z0, z0 + 2 extent] on
    a (res + 1)^2 grid, two triangles per cell."""
    xs = np.linspace(-extent, extent, res + 1, dtype=np.float32)
    zs = np.linspace(z0, z0 + 2 * extent, res + 1, dtype=np.float32)
    xg, zg = np.meshgrid(xs, zs)
    yg = (y + 0.3 * np.sin(0.45 * xg) * np.cos(0.35 * zg)
          + 0.1 * np.sin(1.3 * xg + 0.5) * np.sin(1.1 * zg)).astype(np.float32)
    v = np.stack([xg, yg, zg], -1).reshape(-1, 3)
    idx = np.arange((res + 1) ** 2).reshape(res + 1, res + 1)
    q00 = idx[:-1, :-1].ravel()
    q10 = idx[:-1, 1:].ravel()
    q01 = idx[1:, :-1].ravel()
    q11 = idx[1:, 1:].ravel()
    f = np.concatenate(
        [np.stack([q00, q10, q11], -1), np.stack([q00, q11, q01], -1)])
    return v, f


def make_inputs(config: dict, seed: int) -> dict:
    """The raw inputs: the PDB text of the configuration's molecule
    (``synthetic_pdb`` at its ``pdb_seed``) with its ATOM records in an
    order drawn from ``seed``, the scale that fits the molecule in
    ``molecule_radius`` scene units, and the ground mesh.  So every seed
    gives the same molecule and the same work (another molecule moves
    the frame's work by a sixth), and the seed still changes what the
    program is handed: the order of the spheres, the bonds and the
    element materials."""
    n = int(config["n_atoms"])
    g = config["ground"]
    vertices, faces = height_mesh(g["res"], g["extent"], g["z0"], g["y"])
    lines = synthetic_pdb(n, int(config["pdb_seed"])).splitlines()
    atoms = lines[:-1]
    order = np.random.default_rng(seed).permutation(len(atoms))
    pdb = "\n".join([atoms[i] for i in order] + lines[-1:]) + "\n"
    return dict(pdb=pdb, scale=config["molecule_radius"] / globule_radius(n),
                ground_vertices=vertices, ground_faces=faces)


def build_port(raw: dict, config: dict, device):
    """(scene, camera) of the system under test: the molecule through
    ``load_pdb`` (atoms, then bonds), then the ground, then the light."""
    from solr_tpu_torch import Camera, SceneBuilder
    from solr_tpu_torch.io.pdb import GeometryMode, load_pdb

    pdb = config["pdb"]
    b = SceneBuilder()
    load_pdb(io.StringIO(raw["pdb"]), b, mode=GeometryMode[pdb["mode"]],
             scale=raw["scale"], atom_scale=pdb["atom_scale"],
             stick_radius=pdb["stick_radius"],
             bond_cutoff=pdb["bond_cutoff"], specular=pdb["specular"])
    ground = b.add_material(**config["materials"]["ground"])
    b.add_mesh(raw["ground_vertices"], raw["ground_faces"], ground)
    light = config["light"]
    b.add_light(tuple(light["position"]), color=tuple(light["color"]),
                intensity=light["intensity"], radius=light["radius"])
    scene = b.build(block=config["block"],
                    bvh_threshold=config["bvh_threshold"], device=device)
    cam = Camera.create(device=device, **config["camera"])
    return scene, cam
