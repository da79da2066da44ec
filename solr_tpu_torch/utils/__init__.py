"""Run utilities (counterpart of solr_tpu/utils): verbosity-gated
logging, per-step metrics, profiler scopes and traces, checkpoint /
resume of inverse-rendering runs, resumable row-band rendering
(``utils.resumable``) and the card's name for records (``card_name``).
XLA's cost analysis (the reference's ``cost_summary``) has no PyTorch
counterpart and is not ported."""

from solr_tpu_torch.utils.card import card_name
from solr_tpu_torch.utils.checkpoint import (CheckpointManager, RenderState,
                                             latest_step,
                                             restore_render_state,
                                             save_render_state)
from solr_tpu_torch.utils.logging import (get_logger, log_error, log_info,
                                          log_warning, set_verbosity)
from solr_tpu_torch.utils.metrics import (MetricsLogger, RaysMeter,
                                          grad_norms, occupancy)
from solr_tpu_torch.utils.profiling import render_phase, trace

__all__ = [
    "CheckpointManager",
    "MetricsLogger",
    "RaysMeter",
    "RenderState",
    "card_name",
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
