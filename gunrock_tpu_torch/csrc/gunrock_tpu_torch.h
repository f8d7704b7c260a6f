/**
 * gunrock_tpu_torch.h: the port's C-callable simplified-array API.
 *
 * Counterpart of native/gunrock_tpu.h (the reference's simplified C
 * tier, gunrock/gunrock.h:173-347: bfs/bc/cc/sssp/pagerank over raw CSR
 * arrays, consumed by shared_lib_tests/*.c). The implementation
 * (c_api.cpp) embeds CPython and calls gunrock_tpu_torch.capi, which
 * wraps the caller's buffers zero-copy and runs the PyTorch primitives
 * on the GPU.
 *
 * Every function returns the elapsed process time in milliseconds, or
 * -1 on failure, a missing GPU included: nothing runs on the CPU.
 */
#ifndef GUNROCK_TPU_TORCH_H
#define GUNROCK_TPU_TORCH_H

#include <stdbool.h>

#ifdef __cplusplus
extern "C" {
#endif

/* BFS labels (hop counts; -1 unreachable). preds may be NULL unless
 * mark_predecessors. Reference: bfs(), gunrock.h:194-206. */
float gunrock_tpu_torch_bfs(int* bfs_label, int* bfs_pred,
                            const int num_nodes, const int num_edges,
                            const int* row_offsets, const int* col_indices,
                            const int source, const bool mark_predecessors,
                            const bool direction_optimized);

/* Betweenness centrality; source < 0 runs all sources. Reference:
 * bc(), gunrock.h:232-239. */
float gunrock_tpu_torch_bc(float* bc_scores, const int num_nodes,
                           const int num_edges, const int* row_offsets,
                           const int* col_indices, const int source);

/* Connected components and their count. Reference: cc(),
 * gunrock.h:264-269. */
float gunrock_tpu_torch_cc(int* component, int* num_components,
                           const int num_nodes, const int num_edges,
                           const int* row_offsets, const int* col_indices);

/* SSSP distances (float32; +inf where unreachable). preds may be NULL
 * unless mark_preds. Reference: sssp(), gunrock.h:304-314. */
float gunrock_tpu_torch_sssp(float* distances, int* preds,
                             const int num_nodes, const int num_edges,
                             const int* row_offsets, const int* col_indices,
                             const float* edge_values, const int source,
                             const bool mark_preds);

/* PageRank: node_ids and ranks sorted by rank, descending. Reference:
 * pagerank(), gunrock.h:341-347. */
float gunrock_tpu_torch_pagerank(int* node_ids, float* pagerank,
                                 const int num_nodes, const int num_edges,
                                 const int* row_offsets,
                                 const int* col_indices,
                                 const bool normalized);

#ifdef __cplusplus
}
#endif

#endif /* GUNROCK_TPU_TORCH_H */
