"""Protein Data Bank import: molecules as spheres and bond cylinders
(counterpart of solr_tpu/io/pdb.py).

ATOM/HETATM records become spheres with CPK radii and colours per
element; bonds become cylinders; the display modes are atoms, atoms and
sticks, sticks and backbone.  The loader adds the same materials,
spheres and cylinders in the same order as the reference.  Its bond
search is vectorised with numpy (the reference loops over atoms in
Python, which takes minutes at 100k atoms) and keeps the reference's
order: by atom i, then neighbour cell in (dx, dy, dz) loop order, then
atom j.
"""

from __future__ import annotations

import enum
import itertools
from typing import Dict

import numpy as np

__all__ = ["load_pdb", "GeometryMode", "CPK_COLORS", "CPK_RADII"]


class GeometryMode(enum.IntEnum):
    ATOMS = 0
    ATOMS_AND_STICKS = 1
    STICKS = 2
    BACKBONE = 3


# CPK element colours (r, g, b) and van der Waals radii in angstroms, the
# reference's tables.
CPK_COLORS: Dict[str, tuple] = {
    "H": (1.00, 1.00, 1.00),
    "C": (0.30, 0.30, 0.30),
    "N": (0.13, 0.20, 1.00),
    "O": (1.00, 0.13, 0.00),
    "S": (1.00, 0.90, 0.13),
    "P": (1.00, 0.50, 0.00),
    "FE": (0.88, 0.40, 0.20),
    "MG": (0.00, 0.55, 0.00),
    "CA": (0.50, 0.50, 0.56),
    "ZN": (0.49, 0.50, 0.69),
    "NA": (0.00, 0.00, 1.00),
    "CL": (0.00, 1.00, 0.00),
}
CPK_RADII: Dict[str, float] = {
    "H": 1.20, "C": 1.70, "N": 1.55, "O": 1.52, "S": 1.80, "P": 1.80,
    "FE": 1.94, "MG": 1.73, "CA": 2.31, "ZN": 2.10, "NA": 2.27,
    "CL": 1.75,
}
_DEFAULT_COLOR = (0.8, 0.2, 0.8)
_DEFAULT_RADIUS = 1.6

# Neighbour-cell offsets in the reference's (dx, dy, dz) loop order.
_OFFSETS = np.asarray(list(itertools.product((-1, 0, 1), repeat=3)), np.int64)


def _element(record: str) -> str:
    el = record[76:78].strip().upper()
    if not el:
        # Fall back to the atom-name column, as the reference does.
        name = record[12:16].strip()
        el = "".join(c for c in name if c.isalpha())[:2].upper()
        if el[:1] in CPK_RADII and el not in CPK_RADII:
            el = el[:1]
    return el


def _read_atoms(lines):
    """(positions (N, 3) float64, elements, CA positions) of the first
    model's ATOM/HETATM records."""
    pos, elements, backbone = [], [], []
    for line in lines:
        if line.startswith(("ATOM", "HETATM")):
            try:
                p = (float(line[30:38]), float(line[38:46]),
                     float(line[46:54]))
            except ValueError:
                continue
            pos.append(p)
            elements.append(_element(line))
            if line[12:16].strip() == "CA":
                backbone.append(p)
        elif line.startswith("ENDMDL"):
            break  # first model only
    return np.asarray(pos, np.float64).reshape(-1, 3), elements, backbone


def bond_pairs(pos: np.ndarray, cutoff: float):
    """Atom pairs (i, j), i < j, with 1e-8 < |p_j - p_i|^2 <= cutoff^2,
    found on a grid of cutoff-sized cells and listed in the reference's
    order: by i, then neighbour cell in (dx, dy, dz) loop order, then j.
    The squared distance is summed in the reference's order."""
    n = pos.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    keys = np.floor(pos / cutoff).astype(np.int64)
    lo = keys.min(0) - 1
    dims = keys.max(0) - lo + 2
    cell = lambda k: ((k[:, 0] - lo[0]) * dims[1] + (k[:, 1] - lo[1])) \
        * dims[2] + (k[:, 2] - lo[2])
    own = cell(keys)
    perm = np.argsort(own, kind="stable")  # ascending atom ids per cell
    sorted_cells = own[perm]
    cut2 = cutoff ** 2
    found = []
    for oi, off in enumerate(_OFFSETS):
        nb = cell(keys + off)
        start = np.searchsorted(sorted_cells, nb, "left")
        cnt = np.searchsorted(sorted_cells, nb, "right") - start
        i = np.repeat(np.arange(n), cnt)
        first = np.repeat(np.cumsum(cnt) - cnt, cnt)
        j = perm[np.repeat(start, cnt) + np.arange(i.shape[0]) - first]
        keep = j > i
        i, j = i[keep], j[keep]
        d = pos[j] - pos[i]
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        ok = (d2 > 1e-8) & (d2 <= cut2)
        found.append((i[ok], np.full(int(ok.sum()), oi), j[ok]))
    i, oi, j = (np.concatenate(x) for x in zip(*found))
    order = np.lexsort((j, oi, i))
    return i[order], j[order]


def load_pdb(source, builder, mode: GeometryMode = GeometryMode.ATOMS_AND_STICKS,
             scale: float = 0.1, atom_scale: float = 0.35,
             stick_radius: float = 0.12, bond_cutoff: float = 1.9,
             center: bool = True, specular: float = 0.5) -> int:
    """Load ATOM/HETATM records into ``builder``; returns the number of
    atoms.  ``source`` is a path or an open text stream.

    ``atom_scale`` shrinks the van der Waals radii for ball-and-stick
    rendering (1.0 is space filling, the atoms mode)."""
    if hasattr(source, "read"):
        pos, elements, backbone = _read_atoms(source)
    else:
        with open(source) as f:
            pos, elements, backbone = _read_atoms(f)
    if not elements:
        return 0
    offset = 0.5 * (pos.min(axis=0) + pos.max(axis=0)) if center else 0.0
    pos = (pos - offset) * scale

    mat_cache: Dict[str, int] = {}

    def mat_for(el: str) -> int:
        if el not in mat_cache:
            color = CPK_COLORS.get(el, _DEFAULT_COLOR)
            mat_cache[el] = builder.add_material(
                color=color + (1.0,), specular=specular, specular_power=40.0)
        return mat_cache[el]

    if mode in (GeometryMode.ATOMS, GeometryMode.ATOMS_AND_STICKS):
        r_scale = atom_scale if mode == GeometryMode.ATOMS_AND_STICKS else 1.0
        for p, el in zip(pos, elements):
            r = CPK_RADII.get(el, _DEFAULT_RADIUS) * scale * r_scale
            builder.add_sphere(tuple(p), r, mat_for(el))

    if mode in (GeometryMode.ATOMS_AND_STICKS, GeometryMode.STICKS):
        grey = builder.add_material(color=(0.6, 0.6, 0.6, 1.0),
                                    specular=specular)
        i, j = bond_pairs(pos, bond_cutoff * scale)
        radius = stick_radius * scale / 0.1
        for a, b in zip(pos[i], pos[j]):
            builder.add_cylinder(tuple(a), tuple(b), radius, grey)

    if mode == GeometryMode.BACKBONE and backbone:
        bb = (np.asarray(backbone) - offset) * scale
        mat = builder.add_material(color=(0.9, 0.6, 0.2, 1.0),
                                   specular=specular)
        for a in bb:
            builder.add_sphere(tuple(a), stick_radius * scale / 0.04, mat)
        for a, b in zip(bb[:-1], bb[1:]):
            builder.add_cylinder(tuple(a), tuple(b),
                                 stick_radius * scale / 0.05, mat)
    return len(elements)
