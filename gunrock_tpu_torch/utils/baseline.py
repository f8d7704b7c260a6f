"""Published reference baselines for bench ratios.

Counterpart of :mod:`gunrock_tpu.utils.baseline`: the nearest published
row of the reference's own Tesla K40c table (``BASELINE.md``, from the
reference's ``doc/stats/engines_topc.md``), picked by primitive and
graph class, so that a bench record can carry ``vs_reference_row``. The
reference's DO-BFS rows count edge inspections in direction-optimized
TEPS (``util/info.cuh:1431``), so a BFS ratio across accounting schemes
is named with its row.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["reference_row", "annotate"]

# (primitive, graph_class) -> (row label, MTEPS on Tesla K40c)
_ROWS = {
    ("bfs", "scalefree"): ("bfs_do rmat_n22_e64 K40c (DO-TEPS accounting)",
                           122516.0),
    ("bfs", "meshy"): ("bfs_do road_usa K40c", 85.3),
    ("sssp", "scalefree"): ("sssp soc-orkut K40c", 216.7),
    ("sssp", "meshy"): ("sssp road_usa K40c", 5.2),
    ("pr", "scalefree"): ("pagerank soc-orkut K40c (per-iter)", 1228.0),
    ("pr", "meshy"): ("pagerank road_usa K40c (per-iter)", 2394.0),
    ("cc", "scalefree"): ("cc soc-orkut K40c", 1005.0),
    ("cc", "meshy"): ("cc road_usa K40c", 276.0),
    ("bc", "scalefree"): ("bc soc-orkut K40c", 1070.0),
    ("bc", "meshy"): ("bc road_usa K40c", 95.9),
}


def reference_row(primitive: str,
                  graph_kind: str) -> Optional[Tuple[str, float]]:
    """Nearest published K40c row for (primitive, graph kind):
    ``graph_kind`` is the bench generator kind (rmat and market are
    scale-free; grid and rgg meshy). None for the primitives the
    reference never published (HITS, SALSA, WTF, TopK, TC)."""
    klass = "meshy" if graph_kind in ("grid", "rgg", "meshy") \
        else "scalefree"
    return _ROWS.get((primitive, klass))


def annotate(rec: dict, primitive: str, graph_kind: str,
             mteps: float) -> dict:
    """Add the ``reference_row`` fields to a bench record in place."""
    row = reference_row(primitive, graph_kind)
    if row is not None:
        rec["reference_row"] = row[0]
        rec["reference_row_mteps"] = row[1]
        rec["vs_reference_row"] = round(mteps / row[1], 4)
    return rec
