/* Host-side MoE planning ops (C, bound with ctypes): the port's own copy
 * of the JAX package's csrc/host_ops/moe_utils.cc.  The port builds this
 * copy, never the original.
 *
 * Counterpart of Triton-distributed's CUDA kernel
 * ``moe_ag_scatter_align_block_size`` (csrc/lib/moe_utils.cu, serial
 * :61-165 and parallel :195-356 variants): for each of ``n_ranks``
 * source-rank segments of gathered top-k expert assignments, stable-sort
 * the assignment indices by expert, pad each expert group to the GEMM
 * row-tile size, and emit the per-tile expert id and per-tile source-rank
 * ("block barrier") id the grouped GEMM consumes.
 *
 * The device path sorts with tensor ops (kernels/moe_utils.py
 * ``sort_align``: a stable argsort and cumsums, no host round trip); this
 * is the host planner, for routing held on the host.  Plain C ABI, no
 * dependencies; built with g++ at first use by runtime/host_ops.py.
 */
#include <stdint.h>
#include <string.h>

#include <vector>

extern "C" {

/* Returns 0 on success, nonzero on bad arguments.
 *
 * topk_ids:        [n_ranks * numel_per_rank] expert id per assignment,
 *                  rank-major (gathered order).
 * capacity:        length of sorted_token_ids; must hold the worst case
 *                  n_ranks * (numel_per_rank + n_experts * (block_m - 1))
 *                  rounded up per expert group.
 * sorted_token_ids [capacity]  global assignment index per sorted slot,
 *                  `pad_value` in padding slots.
 * tile_expert      [capacity / block_m]  expert id per row tile.
 * tile_src_rank    [capacity / block_m]  source rank per row tile (the
 *                  reference's block_barrier_ids).
 * rank_block_num   [n_ranks]  number of row tiles for each rank segment.
 * total_padded     [1]  total rows after padding (sum over segments).
 */
int tdt_moe_ag_scatter_align_block_size(
    const int32_t* topk_ids, int64_t numel_per_rank, int32_t n_ranks,
    int32_t n_experts, int32_t block_m, int32_t pad_value, int64_t capacity,
    int32_t* sorted_token_ids, int32_t* tile_expert, int32_t* tile_src_rank,
    int32_t* rank_block_num, int32_t* total_padded) {
  if (numel_per_rank < 0 || n_ranks <= 0 || n_experts <= 0 || block_m <= 0)
    return 1;
  for (int64_t i = 0; i < capacity; ++i) sorted_token_ids[i] = pad_value;
  std::vector<int64_t> counts((size_t)n_experts);
  std::vector<int64_t> group_start((size_t)n_experts + 1);
  std::vector<int64_t> fill((size_t)n_experts);

  int64_t base = 0;  /* padded rows emitted so far */
  for (int32_t r = 0; r < n_ranks; ++r) {
    const int32_t* seg = topk_ids + (int64_t)r * numel_per_rank;
    memset(counts.data(), 0, counts.size() * sizeof(int64_t));
    for (int64_t i = 0; i < numel_per_rank; ++i) {
      int32_t e = seg[i];
      if (e < 0 || e >= n_experts) return 2;
      ++counts[(size_t)e];
    }
    /* pad each expert group to block_m; prefix-sum group starts */
    group_start[0] = 0;
    for (int32_t e = 0; e < n_experts; ++e) {
      int64_t padded = (counts[(size_t)e] + block_m - 1) / block_m * block_m;
      group_start[(size_t)e + 1] = group_start[(size_t)e] + padded;
    }
    int64_t seg_rows = group_start[(size_t)n_experts];
    if (base + seg_rows > capacity) return 3;

    /* stable scatter: original order within each expert group */
    memset(fill.data(), 0, fill.size() * sizeof(int64_t));
    for (int64_t i = 0; i < numel_per_rank; ++i) {
      int32_t e = seg[i];
      int64_t dst = base + group_start[(size_t)e] + fill[(size_t)e]++;
      sorted_token_ids[dst] = (int32_t)((int64_t)r * numel_per_rank + i);
    }
    /* per-tile expert + source rank */
    for (int32_t e = 0; e < n_experts; ++e) {
      for (int64_t row = group_start[(size_t)e];
           row < group_start[(size_t)e + 1]; row += block_m) {
        int64_t t = (base + row) / block_m;
        tile_expert[t] = e;
        tile_src_rank[t] = r;
      }
    }
    rank_block_num[r] = (int32_t)(seg_rows / block_m);
    base += seg_rows;
  }
  *total_padded = (int32_t)base;
  return 0;
}

/* Stable rank-within-group for a flat key array (the shared slot-allocation
 * idiom; device counterpart: moe_utils.stable_rank_in_group).  Returns 0
 * on success. */
int tdt_stable_rank_in_group(const int32_t* keys, int64_t n,
                             int32_t n_groups, int32_t* rank,
                             int32_t* counts) {
  if (n < 0 || n_groups <= 0) return 1;
  std::vector<int64_t> fill((size_t)n_groups, 0);
  for (int64_t i = 0; i < n; ++i) {
    int32_t k = keys[i];
    if (k < 0 || k >= n_groups) return 1;
    rank[i] = (int32_t)fill[(size_t)k]++;
  }
  for (int32_t g = 0; g < n_groups; ++g) counts[g] = (int32_t)fill[(size_t)g];
  return 0;
}

}  /* extern "C" */
