"""Plain PageRank reference (LDBC Graphalytics' PR): its own CSR and the
power iteration, in PyTorch float64.

It takes the benchmark's COO and nothing that the program built: it
symmetrizes an undirected graph, drops self-loops and duplicate edges,
sorts, and runs the iteration. It imports nothing of the program and
reads no edge values (PageRank has none).

The guarantee it holds an answer to (the configuration states it):
``ranks`` holds each vertex's PageRank after exactly ``iterations``
rounds of

    PR(v) = (1-d)/n + d * sum_{u->v} PR(u)/deg(u) + (d/n) * sum_{w dangling} PR(w)

from PR_0 = 1/n, with ``d`` the damping and ``deg`` the out-degree
(a dangling vertex has none), within :data:`RTOL` of this reference;
``node_ids`` is every vertex once, by descending rank, ties by
ascending id, over the answer's own ranks.
"""

from __future__ import annotations

import numpy as np
import torch

# What judge() counts, and the most of each a correct run may have.
LIMITS = {"rank_off": 0, "bad_order": 0}
# A vertex's rank is off where |rank - ref| > ATOL + RTOL * ref.
# ATOL 0: every rank is at least (1-d)/n > 0, so the relative error is
# defined at every vertex and needs no absolute floor.
# RTOL: the program carries float32 ranks and sums them in float32
# (kernel K3); its largest relative error at cell size on the card is
# measured in PERF.md section 2, with the controls' smallest, and RTOL
# lies between them. judge() gives that error, ``rank_rel_err``, as a
# reading beside its counts.
ATOL, RTOL = 0.0, 1e-4
# The control variants (Reference.control), each of which must fail.
CONTROLS = ("one_iteration_short", "damping_off", "bf16_ranks")


class Reference:
    def __init__(self, num_nodes: int, src: np.ndarray, dst: np.ndarray, *,
                 undirected: bool, device: torch.device,
                 damping: float, iterations: int):
        n = int(num_nodes)
        s = torch.from_numpy(np.asarray(src)).to(device, torch.int64)
        d = torch.from_numpy(np.asarray(dst)).to(device, torch.int64)
        if undirected:
            s, d = torch.cat([s, d]), torch.cat([d, s])
        keep = s != d
        keys = torch.unique(s[keep] * n + d[keep])
        del s, d, keep
        self.n, self.device = n, device
        self.row, self.col = keys // n, keys % n
        del keys
        self.deg = torch.bincount(self.row, minlength=n)
        self.num_edges = int(self.row.numel())
        self.damping, self.iterations = float(damping), int(iterations)
        self._ranks = None

    def ranks(self, damping: float = None, iterations: int = None,
              carry: torch.dtype = torch.float64) -> torch.Tensor:
        """(n,) float64 ranks after ``iterations`` rounds (default: the
        configuration's), each round's ranks rounded to ``carry``."""
        d = self.damping if damping is None else float(damping)
        iters = self.iterations if iterations is None else int(iterations)
        n = self.n
        deg = self.deg.to(torch.float64)
        inv = torch.where(self.deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)
        dangling = self.deg == 0
        rank = torch.full((n,), 1.0 / n, dtype=torch.float64,
                          device=self.device).to(carry).double()
        for _ in range(iters):
            incoming = torch.zeros(n, dtype=torch.float64,
                                   device=self.device)
            incoming.index_add_(0, self.col, (rank * inv)[self.row])
            rank = ((1.0 - d) / n + d * incoming
                    + d * rank[dangling].sum() / n).to(carry).double()
        return rank

    def work(self, rule: str, roots) -> list[int]:
        """Each root's work by ``rule`` (a whole-graph query's one root
        is None). ``edges_times_iterations``: the directed edges times
        the iterations, the edges each query pulls over (Gunrock's
        PageRank accounting, ``edges_visited``)."""
        if rule != "edges_times_iterations" or list(roots) != [None]:
            raise ValueError(f"unknown work rule {rule!r} for roots "
                             f"{list(roots)[:3]}")
        return [self.num_edges * self.iterations]

    def judge(self, root, answer: dict) -> dict:
        """Counts of what ``answer`` (``ranks`` and ``node_ids``, host
        arrays) gets wrong against this reference (:data:`LIMITS` gives
        what a correct run may have), and the reading ``rank_rel_err``,
        its largest relative error."""
        if root is not None:
            raise ValueError("PageRank takes no root")
        n, dev = self.n, self.device
        if self._ranks is None:
            self._ranks = self.ranks()
        ref = self._ranks
        ranks, ids = answer.get("ranks"), answer.get("node_ids")
        got = None
        if ranks is None or np.shape(ranks) != (n,):
            rank_off, rel = n, float("inf")
        else:
            got = torch.as_tensor(np.asarray(ranks), device=dev).double()
            err = (got - ref).abs()
            rank_off = int((~(err <= ATOL + RTOL * ref)).sum())
            rel = float((err / ref).max()) if n else 0.0
            if rel != rel:   # a NaN rank
                rel = float("inf")
        if ids is None or np.shape(ids) != (n,):
            return {"rank_off": rank_off, "bad_order": n,
                    "rank_rel_err": rel}
        ids = torch.as_tensor(np.asarray(ids), device=dev).long()
        inside = (ids >= 0) & (ids < n)
        bad = int((~inside).sum())
        bad += int((torch.bincount(ids[inside], minlength=n) != 1).sum())
        if got is None:
            bad += n
        elif n > 1:
            r = got[ids.clamp(0, n - 1)]
            ok = (r[:-1] > r[1:]) | ((r[:-1] == r[1:]) & (ids[:-1] < ids[1:]))
            bad += int((~ok).sum())
        return {"rank_off": rank_off, "bad_order": bad, "rank_rel_err": rel}

    def control(self, root, variant: str) -> dict:
        """The reference in the program's place with one guarantee
        broken: ``one_iteration_short`` runs one round fewer,
        ``damping_off`` takes d = 0.84 for 0.85 (one hundredth less),
        ``bf16_ranks`` carries the ranks in bfloat16, a lower precision
        than the configuration's float32. Ranks as float32, ordered as
        the guarantee says."""
        if variant == "one_iteration_short":
            rank = self.ranks(iterations=self.iterations - 1)
        elif variant == "damping_off":
            rank = self.ranks(damping=self.damping - 0.01)
        elif variant == "bf16_ranks":
            rank = self.ranks(carry=torch.bfloat16)
        else:
            raise ValueError(f"unknown control {variant!r}")
        rank = rank.float()
        order = torch.sort(-rank, stable=True).indices.to(torch.int32)
        return {"ranks": rank.cpu().numpy(), "node_ids": order.cpu().numpy()}
