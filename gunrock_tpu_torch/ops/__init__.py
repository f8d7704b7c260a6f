from .advance import (  # noqa: F401
    ExpandedEdges, expand, expand_inverse, pull_reduce,
)
from .filter import cull_filter, bypass_filter  # noqa: F401
from .segment import (  # noqa: F401
    scatter_min, scatter_max, scatter_add, scatter_set,
    dedup_winners, compact, frontier_from_mask, mask_from_frontier,
    row_reduce_sorted,
)
