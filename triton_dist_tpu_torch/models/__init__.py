"""Llama-family model code: config and parameters, sampling, generation,
context-parallel training (``cp``) and pipelined training (``pp``), their
entries re-exported under the reference's names."""

from triton_dist_tpu_torch.models.cp import (  # noqa: F401
    cp_forward_shard,
    cp_loss,
    make_cp_forward,
    make_cp_train_step,
    place_cp_params,
)
from triton_dist_tpu_torch.models.pp import (  # noqa: F401
    init_pp_params,
    make_pp_grads,
    make_pp_train_step,
    place_pp_params,
    pp_param_specs,
)
