"""Layers: attention over KV caches, tensor-parallel linears, the MoE and
all-to-all layers, and the all-gather layer."""

from triton_dist_tpu_torch.layers.allgather_layer import (  # noqa: F401
    LATENCY_BOUND_BYTES,
    AllGatherLayer,
)
