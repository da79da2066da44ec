"""Asset I/O (counterpart of solr_tpu/io): the OBJ/MTL, PDB and SWC
importers, IRT scene files, and images."""

from solr_tpu_torch.io.image import load_image
from solr_tpu_torch.io.irt import load_scene, save_scene
from solr_tpu_torch.io.obj import load_obj
from solr_tpu_torch.io.pdb import CPK_COLORS, CPK_RADII, GeometryMode, load_pdb
from solr_tpu_torch.io.swc import load_swc

__all__ = [
    "load_obj",
    "load_pdb",
    "load_swc",
    "save_scene",
    "load_scene",
    "load_image",
    "GeometryMode",
    "CPK_COLORS",
    "CPK_RADII",
]
