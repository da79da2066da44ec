"""Run utilities (counterpart of solr_tpu/utils): verbosity-gated
logging, per-step metrics, checkpoint / resume of inverse-rendering runs,
and resumable row-band rendering (``utils.resumable``).  The
reference's profiling helpers are not ported (ROADMAP A16)."""

from solr_tpu_torch.utils.checkpoint import (CheckpointManager, RenderState,
                                             latest_step,
                                             restore_render_state,
                                             save_render_state)
from solr_tpu_torch.utils.logging import (get_logger, log_error, log_info,
                                          log_warning, set_verbosity)
from solr_tpu_torch.utils.metrics import (MetricsLogger, RaysMeter,
                                          grad_norms, occupancy)

__all__ = [
    "CheckpointManager",
    "MetricsLogger",
    "RaysMeter",
    "RenderState",
    "get_logger",
    "grad_norms",
    "latest_step",
    "log_error",
    "log_info",
    "log_warning",
    "occupancy",
    "restore_render_state",
    "save_render_state",
    "set_verbosity",
]
