"""Data, tensor and spatial parallelism over ``torch.distributed``: the
port's counterpart of ``sr3d_tpu/parallel/`` (one process per rank;
``torchrun --nproc_per_node=N`` for users)."""

from .layout import Layout, average_gradients, current, use
from .mesh import (DATA_AXIS, MODEL_AXIS, Axis, Mesh, barrier,
                   init_distributed, is_main_rank, local_mesh_or_single,
                   local_rows, make_mesh, replicated)
from .steps import (data_layout, pjit_sample, pjit_sample_spatial,
                    pjit_train_step, shard_module_tp, shard_state_dp_tp,
                    spatial_layout,
                    state_shardings, tp_param_sharding, unsharded)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Axis", "Layout", "Mesh",
    "average_gradients", "barrier", "current", "data_layout",
    "init_distributed", "is_main_rank", "local_mesh_or_single",
    "local_rows", "make_mesh", "pjit_sample", "pjit_sample_spatial",
    "pjit_train_step", "replicated", "shard_module_tp",
    "shard_state_dp_tp", "spatial_layout",
    "state_shardings", "tp_param_sharding", "unsharded", "use",
]
