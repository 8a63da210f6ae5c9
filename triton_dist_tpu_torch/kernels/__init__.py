"""Hand-written Hopper CUDA kernels (``csrc/``) behind wrappers that take
their plain PyTorch versions for CPU tensors only.

Context parallelism's names are re-exported here as the reference's
package does, except the host entries ``ring_attention`` and
``ulysses_attention``: those names stay the modules (reach the entries as
``ring_attention.ring_attention``), so ``from triton_dist_tpu_torch.kernels
import ring_attention`` always gives the module.  The collectives (the
barrier, all-gather, reduce-scatter, the latency-tuned all-gather and the
hierarchical compositions) are re-exported under the reference's names,
except the host entry ``reduce_scatter``, which stays the module, as
above.  So are the TP ring GEMMs' contexts, host entries (``ag_gemm``,
``ag_gemm_gathered``, ``gemm_rs``), rank-stacked shard functions and
autotuned entries, and the MoE overlap kernels' (``ag_group_gemm``,
``moe_reduce_rs_autotuned``, ...), except the host entry
``moe_reduce_rs``: that name stays the module (reach the entry as
``moe_reduce_rs.moe_reduce_rs``)."""

from triton_dist_tpu_torch.kernels.allgather import (  # noqa: F401
    AllGatherContext,
    AllGatherMethod,
    all_gather,
    all_gather_shard,
    choose_allgather_method,
    create_allgather_context,
)
from triton_dist_tpu_torch.kernels.allgather_gemm import (  # noqa: F401
    AllGatherGEMMContext,
    ag_gemm,
    ag_gemm_autotuned,
    ag_gemm_gathered,
    ag_gemm_shard,
    create_ag_gemm_context,
)
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (  # noqa: F401
    AGGroupGEMMContext,
    ag_group_gemm,
    ag_group_gemm_autotuned,
    ag_group_gemm_shard,
    create_ag_group_gemm_context,
)
from triton_dist_tpu_torch.kernels.common_ops import (  # noqa: F401
    barrier_all_on_mesh,
)
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (  # noqa: F401
    GEMMReduceScatterContext,
    create_gemm_rs_context,
    gemm_rs,
    gemm_rs_autotuned,
    gemm_rs_shard,
)
from triton_dist_tpu_torch.kernels.hierarchical import (  # noqa: F401
    hier_all_gather_shard,
    hier_all_reduce_shard,
    hier_all_to_all_shard,
    hier_grad_allreduce,
    hier_reduce_scatter_shard,
    hier_rs_band_index,
)
from triton_dist_tpu_torch.kernels.low_latency_allgather import (  # noqa: F401
    FastAllGatherContext,
    create_fast_ag_context,
    fast_allgather,
    pack_payload,
    unpack_payload,
)
from triton_dist_tpu_torch.kernels.moe_reduce_rs import (  # noqa: F401
    MoEReduceRSContext,
    create_moe_rs_context,
    moe_reduce_rs_autotuned,
    moe_reduce_rs_shard,
)
from triton_dist_tpu_torch.kernels.reduce_scatter import (  # noqa: F401
    ReduceScatterContext,
    ReduceScatterMethod,
    create_reduce_scatter_context,
    reduce_scatter_shard,
)

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
