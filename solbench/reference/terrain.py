"""The reference's terrain scene, from the raw inputs the benchmark made:
the terrain's triangles (one shading normal per face), the mirror
spheres, and the light as an emissive sphere plus a point light.
Material order: terrain, mirror, light."""

from __future__ import annotations

import torch

from solbench.reference.render import (RefScene, empty_pools, face_normals,
                                       info_fields, materials)


def reference_scene(raw: dict, config: dict, device, dtype) -> RefScene:
    def ten(x):
        return torch.as_tensor(x, device=device).to(dtype)

    mats = config["materials"]
    light = config["light"]
    light_mat = dict(color=light["color"], emission=light["intensity"])
    verts = ten(raw["vertices"])
    faces = torch.as_tensor(raw["faces"], device=device).long()
    v0, v1, v2 = (verts[faces[:, k]] for k in range(3))
    n_sph = raw["sphere_centers"].shape[0]
    centers = torch.cat([ten(raw["sphere_centers"]),
                         ten([light["position"]])])
    radii = torch.cat([ten(raw["sphere_radii"]), ten([light["radius"]])])
    fields = empty_pools(device, dtype)
    fields.update(
        sph_center=centers, sph_radius=radii,
        sph_material=torch.tensor([1] * n_sph + [2], device=device),
        tri_v0=v0, tri_v1=v1, tri_v2=v2, tri_normal=face_normals(v0, v1, v2),
        tri_material=torch.zeros(v0.shape[0], dtype=torch.int64,
                                 device=device))
    return RefScene(
        **materials([mats["terrain"], mats["mirror"], light_mat], device,
                    dtype),
        **fields,
        light_position=ten([light["position"]]),
        light_color=ten([light["color"][:3]]) * light["intensity"],
        **info_fields(config["info"], config["gradient_background"], device,
                      dtype))
