"""Scene importers (counterpart of solr_tpu/io)."""

from solr_tpu_torch.io.pdb import CPK_COLORS, CPK_RADII, GeometryMode, load_pdb

__all__ = ["load_pdb", "GeometryMode", "CPK_COLORS", "CPK_RADII"]
