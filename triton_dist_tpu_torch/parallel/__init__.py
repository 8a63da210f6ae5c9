"""Parallel schedules: the GPipe pipeline over a stage axis."""

from triton_dist_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_spmd,
    stack_layer_params,
)
