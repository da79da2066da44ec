"""The ball-and-stick molecule frame: the reference's ``MoleculeScene``
with a PDB file (solr_tpu/scenes/gallery.py:149-179, ``load_pdb`` in
ATOMS_AND_STICKS mode) standing over a reflective heightfield ground
(the gallery's ``_height_mesh``, gallery.py:829-843), built without the
reference package.

No PDB file ships with the repository, so ``synthetic_pdb`` writes a
seeded, protein-like one: a chain of heavy atoms folded into a globule
of protein density.  ``molecule_scene_parts`` returns the PDB text and
the raw settings, so a test can feed the same frame to
``solr_tpu.SceneBuilder``; ``molecule_scene`` builds this package's
scene, camera and config.
"""

from __future__ import annotations

import io
import math

import numpy as np

from solr_tpu_torch.io.pdb import GeometryMode, load_pdb
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import Camera, RenderConfig

__all__ = ["synthetic_pdb", "globule_radius", "height_mesh",
           "molecule_scene_parts", "molecule_scene"]

BOND = 1.53  # angstroms, a C-C single bond
# cos and sin of 69 degrees, the turn between successive bonds at a bond
# angle of 111 degrees (literals, so the chain needs no libm call and is
# the same on every machine).
_COS_TURN = 0.35836794954530027
_SIN_TURN = 0.9335804264972017
DENSITY = 0.06  # heavy atoms per cubic angstrom in a folded protein
_TRIES = 8  # torsion redraws before a step that would leave turns inward
# Heavy-atom shares C, N, O, S (63/17/19/1 %) of the atoms that are not
# CA; every 4th atom is a CA carbon.
_ELEMENTS = ("C", "N", "O", "S")
_CDF_NON_CA = np.cumsum([0.63 - 0.25, 0.17, 0.19, 0.01]) / 0.75

MOLECULE_RADIUS = 2.5  # scene units
GROUND = dict(res=128, extent=12.0, z0=-4.0, y=-3.0)


def globule_radius(n_atoms: int) -> float:
    """Radius in angstroms of a sphere that holds n_atoms at DENSITY,
    rounded to 1e-3 so that it is the same number on every machine."""
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
    """Positions of a chain of n atoms inside a sphere of ``radius``: bond
    BOND, bond angle 111 degrees, random torsion.  A step that would
    leave the sphere redraws its torsion up to _TRIES times, then heads
    for the centre.  Only +, -, *, / and sqrt, so every IEEE machine
    gives the same chain."""
    r2 = radius * radius
    pts = [(0.0, 0.0, 0.0)]
    ux, uy, uz = _unit(draw() - 0.5, draw() - 0.5, draw() - 0.5)
    for _ in range(n - 1):
        cx, cy, cz = pts[-1]
        # An orthonormal pair (e1, e2) perpendicular to the last bond u.
        ax, ay, az = (1.0, 0.0, 0.0) if abs(ux) < 0.9 else (0.0, 1.0, 0.0)
        e1 = _unit(uy * az - uz * ay, uz * ax - ux * az, ux * ay - uy * ax)
        e2 = (uy * e1[2] - uz * e1[1], uz * e1[0] - ux * e1[2],
              ux * e1[1] - uy * e1[0])
        for _ in range(_TRIES):
            while True:  # a uniform point of the unit disk: the torsion
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
        else:  # turn inward
            vx, vy, vz = _unit(-cx, -cy, -cz)
            px, py, pz = cx + BOND * vx, cy + BOND * vy, cz + BOND * vz
        ux, uy, uz = _unit(vx, vy, vz)
        pts.append((px, py, pz))
    return pts


def synthetic_pdb(n_atoms: int = 100_000, seed: int = 42) -> str:
    """A protein-like PDB text of n_atoms heavy atoms: a chain folded
    into a globule of DENSITY (about 73 angstroms across at 100k atoms),
    elements C/N/O/S at about 63/17/19/1 %, every 4th atom a CA.  ATOM
    records in the columns ``load_pdb`` reads (name 12-16, x/y/z 30-54,
    element 76-78); serials and residue numbers wrap at their column
    widths."""
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
    """The ground: a gentle heightfield about height y over
    x in [-extent, extent], z in [z0, z0 + 2 extent], as the gallery's
    ``_height_mesh`` lays it out (2 res^2 triangles)."""
    xs = np.linspace(-extent, extent, res + 1, dtype=np.float32)
    zs = np.linspace(z0, z0 + 2 * extent, res + 1, dtype=np.float32)
    xg, zg = np.meshgrid(xs, zs)
    yg = (y + 0.3 * np.sin(0.45 * xg) * np.cos(0.35 * zg)
          + 0.1 * np.sin(1.3 * xg + 0.5) * np.sin(1.1 * zg)).astype(np.float32)
    v = np.stack([xg, yg, zg], -1).reshape(-1, 3)
    idx = np.arange((res + 1) ** 2).reshape(res + 1, res + 1)
    q00, q10 = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    q01, q11 = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    f = np.concatenate([np.stack([q00, q10, q11], -1),
                        np.stack([q00, q11, q01], -1)])
    return v, f


def molecule_scene_parts(n_atoms: int = 100_000, ground_res: int = 128,
                         seed: int = 42) -> dict:
    """The PDB text, load_pdb settings, ground mesh, materials, light,
    camera and packet settings of the molecule frame."""
    vertices, faces = height_mesh(ground_res, GROUND["extent"], GROUND["z0"],
                                  GROUND["y"])
    return dict(
        pdb=synthetic_pdb(n_atoms, seed),
        load=dict(mode=GeometryMode.ATOMS_AND_STICKS,
                  scale=MOLECULE_RADIUS / globule_radius(n_atoms)),
        ground_vertices=vertices,
        ground_faces=faces,
        ground_material=dict(color=(0.7, 0.7, 0.7, 1.0), specular=0.5,
                             reflection=0.4),
        light_position=(5.0, 8.0, -5.0),  # DemoScene.default_light
        light_intensity=1.0,
        camera=dict(position=(0.0, 0.0, -6.0), fov=0.9),  # MoleculeScene
        config=dict(packet_tile_w=16, packet_tile_h=16, packet_max_blocks=64,
                    packet_tile_cand=256),
        bvh_threshold=64,
    )


def molecule_scene(n_atoms: int = 100_000, ground_res: int = 128,
                   width: int = 512, height: int = 512, bounces: int = 2,
                   block: int = 256, seed: int = 42, device="cuda"):
    """(scene, camera, config) of the molecule frame on ``device``: the
    molecule loaded in the reference's order (atoms, bonds), then the
    ground, then the light."""
    a = molecule_scene_parts(n_atoms, ground_res, seed)
    b = SceneBuilder()
    load_pdb(io.StringIO(a["pdb"]), b, **a["load"])
    ground = b.add_material(**a["ground_material"])
    b.add_mesh(a["ground_vertices"], a["ground_faces"], ground)
    b.add_light(a["light_position"], intensity=a["light_intensity"])
    scene = b.build(block=block, bvh_threshold=a["bvh_threshold"],
                    device=device)
    cam = Camera.create(device=device, **a["camera"])
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       **a["config"])
    return scene, cam, cfg
