"""Parallelism: data x model meshes over ``torch.distributed`` (port of
``fairmultimodal_tpu/parallel``).

One process per rank.  The ``data`` axis splits each batch on its leading
axis: losses are global masked means, gradients summed in one flat
all-reduce per step over the data group.  The ``model`` axis is Megatron
tensor parallelism (:func:`~fairmultimodal_torch.parallel.sharding.shard_params_tp`
with the JAX package's :data:`DEFAULT_TP_RULES`): each rank of a model group
holds its shard of every column- / row-parallel pair and the replicated
rest, with one all-reduce after each row-parallel product.
"""

from fairmultimodal_torch.parallel.sharding import (
    DEFAULT_TIMEOUT_S,
    DEFAULT_TP_RULES,
    Mesh,
    all_agree,
    all_reduce_flat,
    barrier,
    full_state_dict,
    gather_rows,
    get_mesh,
    global_sum,
    launch,
    launched,
    load_full_state_dict,
    mesh_devices,
    parse_mesh,
    replicate,
    shard_batch,
    shard_params_tp,
    shard_state_dict,
    tp_plan,
)

__all__ = ["Mesh", "get_mesh", "parse_mesh", "mesh_devices", "launch", "launched",
           "shard_batch", "replicate", "shard_params_tp", "DEFAULT_TP_RULES", "global_sum",
           "all_reduce_flat", "gather_rows", "all_agree", "barrier", "DEFAULT_TIMEOUT_S",
           "tp_plan", "full_state_dict", "shard_state_dict", "load_full_state_dict"]
