/* C consumer of the PyTorch port's simplified-array ABI.
 *
 * Counterpart of examples/capi_example.c (the reference's
 * shared_lib_tests/shared_lib_bfs.c and simple_example.c): with no
 * arguments, build a small CSR graph in plain C arrays, run CC, BFS,
 * SSSP, PageRank and BC through gunrock_tpu_torch/csrc/gunrock_tpu_torch.h
 * on the GPU, print and check the results. With arguments, run
 * direction-optimized BFS over a CSR read from two files of raw int32
 * (row offsets, column indices) and write the labels to a third:
 *
 *   capi_example_torch ROW.bin COL.bin NUM_NODES NUM_EDGES SOURCE LABELS.bin
 *
 * Build (chip_smoke.py phase 30 does this), with the shim from
 * gunrock_tpu_torch.capi.build_capi_lib():
 *   gcc capi_example_torch.c -o capi_example_torch \
 *       -I../gunrock_tpu_torch/csrc -L$BUILD -l:libgunrock_tpu_torch_capi_*.so \
 *       -Wl,-rpath,$BUILD -lm
 */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>

#include "gunrock_tpu_torch.h"

static int* read_ints(const char* path, long n) {
  FILE* f = fopen(path, "rb");
  int* buf = (int*)malloc((size_t)n * sizeof(int));
  if (!f || !buf || fread(buf, sizeof(int), (size_t)n, f) != (size_t)n) {
    fprintf(stderr, "cannot read %ld ints from %s\n", n, path);
    exit(1);
  }
  fclose(f);
  return buf;
}

static int bfs_files(char** argv) {
  const int num_nodes = atoi(argv[3]);
  const int num_edges = atoi(argv[4]);
  int* row_offsets = read_ints(argv[1], (long)num_nodes + 1);
  int* col_indices = read_ints(argv[2], num_edges);
  int* label = (int*)malloc((size_t)num_nodes * sizeof(int));
  float t = gunrock_tpu_torch_bfs(label, NULL, num_nodes, num_edges,
                                  row_offsets, col_indices, atoi(argv[5]),
                                  /*mark_predecessors=*/false,
                                  /*direction_optimized=*/true);
  if (t < 0) { fprintf(stderr, "bfs failed\n"); return 1; }
  FILE* f = fopen(argv[6], "wb");
  if (!f || fwrite(label, sizeof(int), (size_t)num_nodes, f) !=
                (size_t)num_nodes) {
    fprintf(stderr, "cannot write %s\n", argv[6]);
    return 1;
  }
  fclose(f);
  printf("bfs: %d vertices, %d edges from %s (%.2f ms)\n", num_nodes,
         num_edges, argv[5], t);
  free(row_offsets);
  free(col_indices);
  free(label);
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 7) return bfs_files(argv);
  /* Two triangles bridged by one edge, plus an isolated vertex:
   *   0-1-2-0   3-4-5-3   2-3   6          (undirected -> both dirs) */
  int row_offsets[] = {0, 2, 4, 7, 10, 12, 14, 14};
  int col_indices[] = {1, 2, 0, 2, 0, 1, 3, 2, 4, 5, 3, 5, 3, 4};
  float edge_values[] = {1, 4, 1, 1, 4, 1, 2, 2, 1, 4, 1, 1, 4, 1};
  const int num_nodes = 7;
  const int num_edges = 14;

  int component[7], num_components = 0;
  float t = gunrock_tpu_torch_cc(component, &num_components, num_nodes,
                                 num_edges, row_offsets, col_indices);
  if (t < 0) { fprintf(stderr, "cc failed\n"); return 1; }
  printf("cc: %d components (%.2f ms):", num_components, t);
  for (int i = 0; i < num_nodes; ++i) printf(" %d", component[i]);
  printf("\n");
  if (num_components != 2) { fprintf(stderr, "BAD cc count\n"); return 1; }

  int label[7], pred[7];
  t = gunrock_tpu_torch_bfs(label, pred, num_nodes, num_edges, row_offsets,
                            col_indices, /*source=*/0,
                            /*mark_predecessors=*/true,
                            /*direction_optimized=*/false);
  if (t < 0) { fprintf(stderr, "bfs failed\n"); return 1; }
  printf("bfs: labels (%.2f ms):", t);
  for (int i = 0; i < num_nodes; ++i) printf(" %d", label[i]);
  printf("\n");
  int expect_label[] = {0, 1, 1, 2, 3, 3, -1};
  for (int i = 0; i < num_nodes; ++i)
    if (label[i] != expect_label[i]) {
      fprintf(stderr, "BAD bfs label[%d]=%d\n", i, label[i]);
      return 1;
    }

  float dist[7];
  t = gunrock_tpu_torch_sssp(dist, pred, num_nodes, num_edges, row_offsets,
                             col_indices, edge_values, /*source=*/0,
                             /*mark_preds=*/true);
  if (t < 0) { fprintf(stderr, "sssp failed\n"); return 1; }
  printf("sssp: distances (%.2f ms):", t);
  for (int i = 0; i < num_nodes; ++i) printf(" %.1f", dist[i]);
  printf("\n");
  float expect_dist[] = {0, 1, 2, 4, 5, 6, HUGE_VALF};
  for (int i = 0; i < num_nodes; ++i)
    if (fabsf(dist[i] - expect_dist[i]) > 1e-4f &&
        !(isinf(dist[i]) && isinf(expect_dist[i]))) {
      fprintf(stderr, "BAD sssp dist[%d]=%f\n", i, dist[i]);
      return 1;
    }

  int node_ids[7];
  float ranks[7];
  t = gunrock_tpu_torch_pagerank(node_ids, ranks, num_nodes, num_edges,
                                 row_offsets, col_indices,
                                 /*normalized=*/true);
  if (t < 0) { fprintf(stderr, "pagerank failed\n"); return 1; }
  printf("pagerank: top node %d rank %.4f (%.2f ms)\n", node_ids[0],
         ranks[0], t);
  for (int i = 1; i < num_nodes; ++i)
    if (ranks[i] > ranks[i - 1] + 1e-6f) {
      fprintf(stderr, "BAD pagerank order at %d\n", i);
      return 1;
    }

  /* BC from 0, then over all sources: the bridge 2-3 carries every
   * path between the triangles. */
  float bc[7];
  float expect_bc[2][7] = {{0, 0, 1.5f, 1, 0, 0, 0}, {0, 0, 6, 6, 0, 0, 0}};
  for (int k = 0; k < 2; ++k) {
    t = gunrock_tpu_torch_bc(bc, num_nodes, num_edges, row_offsets,
                             col_indices, /*source=*/k == 0 ? 0 : -1);
    if (t < 0) { fprintf(stderr, "bc failed\n"); return 1; }
    printf("bc from %s (%.2f ms):", k == 0 ? "0" : "all", t);
    for (int i = 0; i < num_nodes; ++i) printf(" %.2f", bc[i]);
    printf("\n");
    for (int i = 0; i < num_nodes; ++i)
      if (fabsf(bc[i] - expect_bc[k][i]) > 1e-4f) {
        fprintf(stderr, "BAD bc[%d]=%f\n", i, bc[i]);
        return 1;
      }
  }

  printf("capi_example_torch: ALL OK\n");
  return 0;
}
