"""AllGather layer: the size policy over the fast all-gather variants.

Counterpart of ``triton_dist_tpu/layers/allgather_layer.py``: small
payloads take the one-shot full-mesh push (latency-bound), large ones the
ring (bandwidth-bound); ``forward_packed`` gathers (out, lse) partials in
one payload.  The kernels are ``kernels/allgather.py``'s (the full-mesh
and ring modes of ``csrc/allgather.cu`` on CUDA tensors, the plain
version on CPU tensors or with ``impl="xla"``).  Inputs are global arrays
sharded on their first dimension, as the reference's host entries take.
"""

from __future__ import annotations

from dataclasses import dataclass

from triton_dist_tpu_torch.kernels.allgather import (
    AllGatherMethod,
    all_gather,
    create_allgather_context,
)
from triton_dist_tpu_torch.kernels.low_latency_allgather import (
    FastAllGatherContext,
    fast_allgather,
    pack_payload,
    unpack_payload,
)

# Payloads at or below this many bytes per rank take the full-mesh push.
LATENCY_BOUND_BYTES = 1 << 20


@dataclass
class AllGatherLayer:
    """Counterpart of the reference's ``AllGatherLayer`` (:43)."""

    ctx: FastAllGatherContext
    latency_bound_bytes: int = LATENCY_BOUND_BYTES

    def forward(self, x):
        """Gather ``x`` (sharded on dim 0 over the context's axes) by size
        policy."""
        nbytes = x.numel() * x.element_size() // max(self.ctx.world, 1)
        if nbytes <= self.latency_bound_bytes:
            return self.forward_push(x)
        return self.forward_ring(x)

    def forward_push(self, x):
        """One-shot full-mesh push."""
        return fast_allgather(x, self.ctx)

    def forward_ring(self, x):
        """The ring gather over the context's axis."""
        method = (AllGatherMethod.XLA if self.ctx.impl == "xla"
                  else AllGatherMethod.RING_1D)
        return all_gather(x, create_allgather_context(
            self.ctx.mesh, axis=self.ctx.axis, method=method))

    def forward_packed(self, out, lse):
        """Gather (out, lse) partials in one f32 payload: out [B, H, D] and
        lse [B, H], sharded on B -> ([W, B / W, H, D], [W, B / W, H])."""
        buf = pack_payload(out.float(), lse.float())
        gathered = fast_allgather(buf, self.ctx)
        return unpack_payload(gathered.reshape(self.ctx.world, -1,
                                               *buf.shape[1:]))
