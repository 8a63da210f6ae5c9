"""Llama-family model code: config and parameters, sampling, generation,
and context-parallel training (``cp``, re-exported under the reference's
names)."""

from triton_dist_tpu_torch.models.cp import (  # noqa: F401
    cp_forward_shard,
    cp_loss,
    make_cp_forward,
    make_cp_train_step,
    place_cp_params,
)
