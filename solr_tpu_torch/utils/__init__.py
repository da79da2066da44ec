"""Run utilities (counterpart of solr_tpu/utils): verbosity-gated
logging, per-step metrics, profiler scopes and traces, checkpoint /
resume of inverse-rendering runs, and resumable row-band rendering
(``utils.resumable``).  ``cost_summary`` (XLA's cost analysis) has no
PyTorch counterpart and raises NotImplementedError."""

from solr_tpu_torch.utils.checkpoint import (CheckpointManager, RenderState,
                                             latest_step,
                                             restore_render_state,
                                             save_render_state)
from solr_tpu_torch.utils.logging import (get_logger, log_error, log_info,
                                          log_warning, set_verbosity)
from solr_tpu_torch.utils.metrics import (MetricsLogger, RaysMeter,
                                          grad_norms, occupancy)
from solr_tpu_torch.utils.profiling import cost_summary, render_phase, trace

__all__ = [
    "CheckpointManager",
    "MetricsLogger",
    "RaysMeter",
    "RenderState",
    "cost_summary",
    "get_logger",
    "grad_norms",
    "latest_step",
    "log_error",
    "log_info",
    "log_warning",
    "occupancy",
    "render_phase",
    "restore_render_state",
    "save_render_state",
    "set_verbosity",
    "trace",
]
