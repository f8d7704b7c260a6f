"""gunrock_tpu_torch — the gunrock_tpu graph library on PyTorch and CUDA.

The port of :mod:`gunrock_tpu` from JAX on a TPU to PyTorch on an NVIDIA
H100. Module paths mirror the JAX package's, so each module's
counterpart is found under the same name. Plain tensor code is PyTorch;
the kernels the JAX package wrote in Pallas are hand-written CUDA for
``sm_90a`` (``csrc/``), built at first use. This package imports no jax.

Every public call takes ``device`` (default ``"cuda"``) and raises when
CUDA is absent; pass ``device="cpu"`` for the plain PyTorch path.

Quick start::

    import gunrock_tpu_torch as gtt
    g = gtt.io.rmat(scale=20, edge_factor=32, seed=1, undirected=True)
    r = gtt.bfs(g, src="largestdegree", mark_preds=True,
                direction_optimized=True, device="cuda")
    r.labels, r.info["m_teps"]
    dg = gtt.to_device(g, with_csc=True, with_blocked_values=True)
    gtt.pagerank(dg, max_iters=20).node_ids[:10]
    g.random_edge_values(seed=7)
    gtt.sssp(g, src="largestdegree", mark_preds=True).distances
    gtt.bc(gtt.to_device(g, with_blocked_values=True), src=0).bc_values
    gtt.cc(g).num_components
    gtt.wtf(g, src=g.largest_degree_vertex()).node_ids[:10]
    gtt.topk(g, k=10).node_ids
    gtt.tc(g).total
    gtt.sample(g, src=0)
    gtt.api.tc(g.num_nodes, g.row_offsets, g.col_indices)
"""

from . import api, graph, io, models, ops, parallel, utils  # noqa: F401
from .graph.csr import CsrGraph, from_coo  # noqa: F401
from .graph.device import DeviceGraph, to_device  # noqa: F401
from .models.bc import bc  # noqa: F401
from .models.bfs import bfs  # noqa: F401
from .models.cc import cc  # noqa: F401
from .models.hits import hits  # noqa: F401
from .models.pr import pagerank  # noqa: F401
from .models.salsa import salsa  # noqa: F401
from .models.sample import sample  # noqa: F401
from .models.sssp import sssp  # noqa: F401
from .models.tc import TcResult, tc  # noqa: F401
from .models.topk import TopkResult, topk  # noqa: F401
from .models.wtf import WtfResult, wtf  # noqa: F401

__version__ = "0.1.0"
