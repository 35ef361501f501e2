"""Parallelism: data-parallel meshes over ``torch.distributed`` (port of
``fairmultimodal_tpu/parallel``).

The JAX package's pure data-parallel mode (``--mesh N`` / ``Nx1``: the
trainer's ``shard_map`` path, the one that keeps the Pallas kernels) becomes
one process per rank, each with a full model replica: batches split on their
leading axis, losses as global masked means, gradients summed in one flat
all-reduce per step.  The ``model`` axis (tensor parallelism) is not ported
(:data:`~fairmultimodal_torch.parallel.sharding.TP_ITEM`).
"""

from fairmultimodal_torch.parallel.sharding import (
    DEFAULT_TIMEOUT_S,
    TP_ITEM,
    Mesh,
    all_agree,
    all_reduce_flat,
    barrier,
    check_data_parallel,
    gather_rows,
    get_mesh,
    global_sum,
    launch,
    launched,
    mesh_devices,
    parse_mesh,
    replicate,
    shard_batch,
)

__all__ = ["Mesh", "get_mesh", "parse_mesh", "mesh_devices", "check_data_parallel", "launch",
           "launched", "shard_batch", "replicate", "global_sum", "all_reduce_flat",
           "gather_rows", "all_agree", "barrier", "TP_ITEM", "DEFAULT_TIMEOUT_S"]
