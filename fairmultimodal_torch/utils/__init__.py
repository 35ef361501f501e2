"""Utilities (port of ``fairmultimodal_tpu.utils``): parameter files and
checkpoints, profiling and tracing, NaN debugging."""

from fairmultimodal_torch.utils.checkpoint import (
    Checkpointer,
    load_metadata_npz,
    load_params_npz,
    save_params_npz,
)
from fairmultimodal_torch.utils.debug import check_finite_tree, enable_nan_checks
from fairmultimodal_torch.utils.profiling import Timer, profile_to, throughput, trace

__all__ = [
    "save_params_npz",
    "load_params_npz",
    "load_metadata_npz",
    "Checkpointer",
    "check_finite_tree",
    "enable_nan_checks",
    "Timer",
    "profile_to",
    "throughput",
    "trace",
]
