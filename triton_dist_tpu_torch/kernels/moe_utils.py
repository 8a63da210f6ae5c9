"""MoE routing and token sort/align: the feeder of the grouped GEMM.

Counterpart of ``triton_dist_tpu/kernels/moe_utils.py``, copied: the
sort/align runs on the device as tensor ops (a stable argsort and cumsums,
no host round trip), and shapes stay static: the padded row count is the
worst case ``round_up(T * topk + E * (block_m - 1), block_m)``.

Data flow (the reference's GroupGEMM contract)::

  tokens [T, D], router logits [T, E]
  -> topk_routing: weights / experts [T, topk]
  -> sort_align(block_m): dest row of every (token, k) pair, per-tile
     expert map, padded row count
  -> gather_sorted: x_sorted [M_pad, D] (padding rows zero)
  -> group_gemm (kernels/group_gemm.py): y_sorted [M_pad, F]
  -> combine_topk: out [T, F] = sum_k w[t, k] * y_sorted[dest[t, k]]

Every scatter is out of place (``index_put`` on a fresh tensor, where the
reference writes ``.at[].set``), so autograd flows through it.
"""

from __future__ import annotations

import torch


def round_up(x, m: int):
    """Round up to a multiple of ``m`` (ints and integer tensors)."""
    return (x + m - 1) // m * m


def padded_rows(n_assignments: int, n_experts: int, block_m: int) -> int:
    """Static worst-case row count after per-expert padding."""
    return round_up(n_assignments + n_experts * (block_m - 1), block_m)


def stable_rank_in_group(keys, n_groups: int):
    """Rank of each element among same-key elements, stable by position.
    Returns ``(rank [n] int32, counts [n_groups] int64)``."""
    n = keys.shape[0]
    keys = keys.long()
    # a scatter-add, not torch.bincount: on the card bincount reads its
    # output size back to the host
    counts = torch.zeros((n_groups,), dtype=torch.int64,
                         device=keys.device).index_add(
                             0, keys, torch.ones_like(keys))
    seg_starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(keys, stable=True)
    rank_sorted = torch.arange(n, device=keys.device) - seg_starts[
        keys[order]]
    rank = torch.zeros((n,), dtype=torch.int64,
                       device=keys.device).index_put((order,), rank_sorted)
    return rank.to(torch.int32), counts


def topk_routing(logits, topk: int):
    """Softmax-then-topk router, renormalised over the chosen experts.
    Returns (weights [T, topk] f32, experts [T, topk] int32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, experts = torch.topk(probs, topk, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, experts.to(torch.int32)


def sort_align(experts, n_experts: int, block_m: int):
    """Stable-sort (token, k) pairs by expert and align groups to block_m.

    experts: [T, topk] int.  Returns a dict:
      dest        [T * topk] int64: row of each assignment in the sorted buffer
      tile_expert [M_pad // block_m] int32: expert of every row tile
                  (trailing padding tiles clamp to expert E - 1)
      valid_rows  [M_pad] bool: False for padding rows
      m_pad       int (static)
    """
    T, topk = experts.shape
    n = T * topk
    flat = experts.reshape(-1).long()
    m_pad = padded_rows(n, n_experts, block_m)
    dev = experts.device

    rank, counts = stable_rank_in_group(flat, n_experts)
    padded_counts = round_up(counts, block_m)
    group_ends = torch.cumsum(padded_counts, 0)
    group_starts = group_ends - padded_counts
    dest = group_starts[flat] + rank

    n_tiles = m_pad // block_m
    tile_rows = torch.arange(n_tiles, device=dev) * block_m
    tile_expert = torch.searchsorted(group_ends, tile_rows, right=True)
    tile_expert = torch.clamp(tile_expert, max=n_experts - 1).to(torch.int32)

    valid = torch.zeros((m_pad,), dtype=torch.bool, device=dev).index_put(
        (dest,), torch.ones((), dtype=torch.bool, device=dev))
    return {"dest": dest, "tile_expert": tile_expert, "valid_rows": valid,
            "m_pad": m_pad}


def gather_sorted(x, dest, m_pad: int):
    """Scatter token rows into the expert-sorted padded buffer.  x: [T, D];
    dest: [T * topk] rows.  Padding rows stay zero, so they contribute
    nothing downstream."""
    T, D = x.shape
    topk = dest.shape[0] // T
    token_of = torch.arange(dest.shape[0], device=x.device) // topk
    return torch.zeros((m_pad, D), dtype=x.dtype, device=x.device).index_put(
        (dest.long(),), x[token_of])


def combine_topk(y_sorted, dest, weights, out_dtype=None):
    """out[t] = sum_k weights[t, k] * y_sorted[dest[t, k]], summed in f32."""
    T, topk = weights.shape
    gathered = y_sorted[dest.reshape(T, topk).long()]          # [T, topk, F]
    out = torch.einsum("tk,tkf->tf", weights.float(), gathered.float())
    return out.to(out_dtype or y_sorted.dtype)
