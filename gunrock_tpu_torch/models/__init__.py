from .bc import bc, bc_device, BcResult  # noqa: F401
from .bfs import bfs, bfs_device, BfsResult  # noqa: F401
from .cc import cc, cc_device, CcResult  # noqa: F401
from .pr import pagerank, pagerank_device, PageRankResult  # noqa: F401
from .hits import hits, hits_device, HitsResult  # noqa: F401
from .salsa import salsa, salsa_device, SalsaResult  # noqa: F401
from .sssp import sssp, sssp_device, SsspResult  # noqa: F401
from .topk import topk, topk_device, TopkResult  # noqa: F401
from .wtf import wtf, wtf_device, WtfResult  # noqa: F401
from .sample import sample  # noqa: F401
from .tc import tc, tc_device, TcResult  # noqa: F401
