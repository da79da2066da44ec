"""The reference's molecule scene, worked out again from the raw inputs:
the PDB text is parsed here (ATOM and HETATM records of the first
model), the atoms become spheres of their element's CPK radius and
colour, and every pair of atoms closer than the bond cutoff becomes a
grey cylinder, found by brute force over all pairs.  Then the ground's
triangles and the light."""

from __future__ import annotations

import torch

from solbench.reference.render import (RefScene, empty_pools, face_normals,
                                       info_fields, materials)

# CPK colours and van der Waals radii (angstroms) of the elements.
CPK_COLORS = {
    "H": (1.00, 1.00, 1.00), "C": (0.30, 0.30, 0.30),
    "N": (0.13, 0.20, 1.00), "O": (1.00, 0.13, 0.00),
    "S": (1.00, 0.90, 0.13), "P": (1.00, 0.50, 0.00),
    "FE": (0.88, 0.40, 0.20), "MG": (0.00, 0.55, 0.00),
    "CA": (0.50, 0.50, 0.56), "ZN": (0.49, 0.50, 0.69),
    "NA": (0.00, 0.00, 1.00), "CL": (0.00, 1.00, 0.00),
}
CPK_RADII = {"H": 1.20, "C": 1.70, "N": 1.55, "O": 1.52, "S": 1.80,
             "P": 1.80, "FE": 1.94, "MG": 1.73, "CA": 2.31, "ZN": 2.10,
             "NA": 2.27, "CL": 1.75}
OTHER_COLOR = (0.8, 0.2, 0.8)
OTHER_RADIUS = 1.6
_PAIR_CHUNK = 512


def parse_pdb(text: str):
    """(positions [[x, y, z], ...] in angstroms, element symbols)."""
    pos, elements = [], []
    for line in text.splitlines():
        if line.startswith("ENDMDL"):
            break
        if not line.startswith(("ATOM", "HETATM")):
            continue
        try:
            p = [float(line[30:38]), float(line[38:46]), float(line[46:54])]
        except ValueError:
            continue
        el = line[76:78].strip().upper()
        if not el:
            name = "".join(c for c in line[12:16].strip() if c.isalpha())
            el = name[:2].upper()
            if el[:1] in CPK_RADII and el not in CPK_RADII:
                el = el[:1]
        pos.append(p)
        elements.append(el)
    return pos, elements


def bonds(pos, cutoff: float):
    """Atom pairs (i, j), i < j, with 1e-8 < |p_j - p_i|^2 <= cutoff^2."""
    n = pos.shape[0]
    cut2 = cutoff * cutoff
    ii, jj = [], []
    cols = torch.arange(n, device=pos.device)
    for s in range(0, n, _PAIR_CHUNK):
        rows = cols[s:s + _PAIR_CHUNK]
        dx, dy, dz = (pos[None, :, k] - pos[rows, None, k] for k in range(3))
        d2 = (dx * dx + dy * dy) + dz * dz
        ok = (cols[None, :] > rows[:, None]) & (d2 > 1e-8) & (d2 <= cut2)
        i, j = ok.nonzero(as_tuple=True)
        ii.append(rows[i])
        jj.append(j)
    return torch.cat(ii), torch.cat(jj)


def reference_scene(raw: dict, config: dict, device, dtype) -> RefScene:
    pdb = config["pdb"]
    scale = float(raw["scale"])
    pos_list, elements = parse_pdb(raw["pdb"])
    pos = torch.tensor(pos_list, dtype=torch.float64, device=device)
    pos = (pos - 0.5 * (pos.amin(0) + pos.amax(0))) * scale
    kinds = sorted(set(elements), key=elements.index)
    mats = [dict(color=CPK_COLORS.get(el, OTHER_COLOR) + (1.0,),
                 specular=pdb["specular"],
                 specular_power=pdb["atom_specular_power"]) for el in kinds]
    mats.append(dict(color=pdb["stick_color"], specular=pdb["specular"],
                     specular_power=pdb["stick_specular_power"]))
    mats.append(config["materials"]["ground"])
    light = config["light"]
    mats.append(dict(color=light["color"], emission=light["intensity"]))
    n_kinds = len(kinds)
    radius = torch.tensor(
        [CPK_RADII.get(el, OTHER_RADIUS) * scale * pdb["atom_scale"]
         for el in elements], dtype=torch.float64, device=device)
    atom_mat = torch.tensor([kinds.index(el) for el in elements],
                            device=device)
    i, j = bonds(pos, pdb["bond_cutoff"] * scale)

    def ten(x):
        return torch.as_tensor(x, device=device).to(dtype)

    verts = ten(raw["ground_vertices"])
    faces = torch.as_tensor(raw["ground_faces"], device=device).long()
    v0, v1, v2 = (verts[faces[:, k]] for k in range(3))
    fields = empty_pools(device, dtype)
    fields.update(
        sph_center=torch.cat([pos.to(dtype), ten([light["position"]])]),
        sph_radius=torch.cat([radius.to(dtype), ten([light["radius"]])]),
        sph_material=torch.cat([atom_mat, atom_mat.new_tensor([n_kinds + 2])]),
        tri_v0=v0, tri_v1=v1, tri_v2=v2, tri_normal=face_normals(v0, v1, v2),
        tri_material=torch.full((v0.shape[0],), n_kinds + 1, device=device),
        cyl_p0=pos[i].to(dtype), cyl_p1=pos[j].to(dtype),
        cyl_radius=torch.full((i.shape[0],),
                              pdb["stick_radius"] * scale / 0.1,
                              dtype=dtype, device=device),
        cyl_material=torch.full((i.shape[0],), n_kinds, device=device))
    return RefScene(
        **materials(mats, device, dtype), **fields,
        light_position=ten([light["position"]]),
        light_color=ten([light["color"][:3]]) * light["intensity"],
        **info_fields(config["info"], config["gradient_background"], device,
                      dtype))
