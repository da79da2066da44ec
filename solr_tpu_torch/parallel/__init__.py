"""Multi-device rendering and gradients on ``torch.distributed``
(counterpart of solr_tpu/parallel).

One process per device; every rank of a mesh calls the same function on
its own band of the frame:

  * tile data-parallel rendering: pixel rows sharded over a mesh of
    ranks, the scene replicated (``broadcast_scene`` once per scene
    change) -- ``shard_render``;
  * distributed inverse rendering: per-rank band losses, scene-parameter
    gradients all-reduced or reduce-scattered (ZeRO-1) over the mesh --
    ``make_sharded_train_step``;
  * the geometry ring: triangle shards rotate past stationary rays --
    ``ring_closest_hit``.

Collectives run on NCCL across cards, or on gloo (CPU tensors, or ranks
that share one card); the caller names the backend
(``initialize_distributed``).
"""

from solr_tpu_torch.parallel.distributed import (initialize_distributed,
                                                 is_distributed,
                                                 process_info)
from solr_tpu_torch.parallel.grads import (init_zero_opt_state,
                                           make_sharded_train_step,
                                           sharded_loss_grad)
from solr_tpu_torch.parallel.mesh import (device_count, make_host_chip_mesh,
                                          make_mesh)
from solr_tpu_torch.parallel.render import broadcast_scene, shard_render
from solr_tpu_torch.parallel.ring import ring_closest_hit, shard_triangles

__all__ = [
    "make_mesh",
    "make_host_chip_mesh",
    "device_count",
    "shard_render",
    "broadcast_scene",
    "make_sharded_train_step",
    "init_zero_opt_state",
    "sharded_loss_grad",
    "initialize_distributed",
    "is_distributed",
    "process_info",
]
