"""Training-run utilities (counterpart of solr_tpu/utils): per-step
metrics and checkpoint / resume of inverse-rendering runs.  The
reference's logging and profiling helpers are not ported (ROADMAP
A16)."""

from solr_tpu_torch.utils.checkpoint import (CheckpointManager, RenderState,
                                             latest_step,
                                             restore_render_state,
                                             save_render_state)
from solr_tpu_torch.utils.metrics import (MetricsLogger, RaysMeter,
                                          grad_norms, occupancy)

__all__ = [
    "CheckpointManager",
    "MetricsLogger",
    "RaysMeter",
    "RenderState",
    "grad_norms",
    "latest_step",
    "occupancy",
    "restore_render_state",
    "save_render_state",
]
