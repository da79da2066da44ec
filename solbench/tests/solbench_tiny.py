"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: about
2,000 triangles or a few hundred atoms, 32 x 32 pixels, with limits of
their own.  At this size a pixel is a thousandth of the frame and a
sphere's silhouette a few pixels, so the numbers of sound runs read
higher than at the cells' size.  The limits sit between the largest
reading of sound runs over ten seeds (bad_px_share 0.003, mean_err
1.3e-6; loss_gap 0.0042, grad_gap 6.0e-4, change_gap 0.016) and the
smallest of the control and the faults (bad_px_share 0.25, mean_err
2.0e-3; loss_gap 0.19, grad_gap 0.078, change_gap 0.58)."""

from __future__ import annotations

import copy

from solbench import manifest

# The tiny sizes of the accepted kinds; a later kind keeps its own as
# ``TINY`` in its scene module, ``scenes/<kind>.py``.
TINY_CONFIG = {"terrain": {"n_tris": 2000}, "molecule": {"n_atoms": 300}}
TINY_LIMITS = {"frames": {"bad_px_share": 0.02, "mean_err": 1e-4,
                          "digest_gap": 0.0},
               "grad": {"loss_gap": 0.02, "grad_gap": 0.01,
                        "change_gap": 0.1}}


def tiny_cell(cell, **workload):
    """The cell ``cell`` (its name, or a :class:`manifest.Cell`) at tiny
    size; ``workload`` overrides keys of its workload file
    (``traversal="while"`` walks a packet cell's frame)."""
    cell = manifest.Cell(cell) if isinstance(cell, str) else cell
    cell.config = copy.deepcopy(cell.config)
    cell.workload = copy.deepcopy(cell.workload)
    kind = cell.config["kind"]
    cell.config.update(TINY_CONFIG[kind] if kind in TINY_CONFIG
                       else cell.scene_kind.TINY)
    cell.workload.update(width=32, height=32, **workload)
    cell.workload["check"]["limits"] = dict(
        TINY_LIMITS[cell.workload["mode"]])
    return cell
