"""Parallelism over ``torch.distributed``, one process per device: data
parallelism over a ``DeviceMesh``'s ``data`` axis through the kernels
(``mesh.py``), and Megatron's tensor parallelism over a 2-D mesh's ``model``
axis on the layers' plain math (``tp.py``). Counterpart of
``deepsvg_tpu/parallel``."""
from .mesh import (
    batch_sharding,
    global_batch_from_local,
    init_distributed,
    make_mesh,
    make_parallel_multi_step,
    make_parallel_resident_multi_step,
    make_parallel_train_step,
    replicated,
    shard_batch,
)
from .tp import (
    TP_RULES,
    gather_params_tp,
    make_tp_train_step,
    shard_state_tp,
    state_tp_shardings,
)

__all__ = [
    "TP_RULES", "batch_sharding", "gather_params_tp", "global_batch_from_local",
    "init_distributed", "make_mesh", "make_parallel_multi_step",
    "make_parallel_resident_multi_step", "make_parallel_train_step", "make_tp_train_step",
    "replicated", "shard_batch", "shard_state_tp", "state_tp_shardings",
]
