"""Attention kernels: hand-written Hopper CUDA kernels (``csrc/``) behind
wrappers that take their plain PyTorch versions for CPU tensors only.

Context parallelism's names are re-exported here as the reference's
package does, except the host entries ``ring_attention`` and
``ulysses_attention``: those names stay the modules (reach the entries as
``ring_attention.ring_attention``), so ``from triton_dist_tpu_torch.kernels
import ring_attention`` always gives the module."""

from triton_dist_tpu_torch.kernels.ring_attention import (  # noqa: F401
    RingAttentionContext,
    create_ring_attention_context,
    from_zigzag,
    ring_attention_shard,
    ring_attn,
    to_zigzag,
    zigzag_indices,
)
from triton_dist_tpu_torch.kernels.ulysses_attention import (  # noqa: F401
    UlyssesContext,
    create_ulysses_context,
    ulysses_attention_shard,
)
