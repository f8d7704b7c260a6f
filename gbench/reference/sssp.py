"""Plain SSSP reference (Graph500 kernel 3): its own weighted CSR and
Bellman-Ford, in PyTorch.

It takes the benchmark's COO and edge values and nothing that the
program built. It keeps Graph500's multigraph as it is: an undirected
edge's reversed copy carries its edge's value, self-loops go, and every
copy of a directed edge stays, so the least weight among the copies
decides a distance (the traffic asks the program's build for the same:
``from_coo`` with ``dedup=False``). It imports nothing of the program.
Its components and work rule are the BFS reference's, over the same
edges, copies counted as Graph500's TEPS counts input edges.

The guarantee it holds an answer to (the configuration states it):
``distances`` equal, bit for bit, the fixpoint of the float32 map
``d[v] = min(d[v], min over u->v of fl(d[u] + w))`` from ``d[root] = 0``
that Bellman-Ford reaches, +inf where unreached; ``preds`` form a tree
rooted at the root: each reached vertex but the root names an
in-neighbour ``u`` with ``fl(d[u] + w) == d[v]`` and its chain of preds
reaches the root; the root names -1 or itself, an unreached vertex -1.

Why the limits are exact (all 0): every route of the program rounds each
relaxation as one float32 add, as this Bellman-Ford does, and the map is
monotone (rounding never reverses an order), so relaxing from the root
in any fair order descends to the same fixpoint: the greatest one below
the start, which these rounds reach. No two routes, and no route and
this reference, may differ in a bit (the program's ``models/sssp.py``
states the same of its routes).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gbench.reference import bfs as _bfs

# What judge() counts, and the most of each a correct run may have.
LIMITS = {"dist_mismatch": 0, "bad_pred": 0, "not_tree": 0}
# The control variants (Reference.control), each of which must fail.
CONTROLS = ("one_round_short", "bf16_weights", "no_tree", "swapped_tie")


class Reference:
    def __init__(self, num_nodes: int, src: np.ndarray, dst: np.ndarray, *,
                 undirected: bool, device: torch.device, values: np.ndarray):
        n = int(num_nodes)
        s = torch.from_numpy(np.asarray(src)).to(device, torch.int64)
        d = torch.from_numpy(np.asarray(dst)).to(device, torch.int64)
        w = torch.from_numpy(np.asarray(values, np.float32)).to(device)
        if undirected:
            s, d, w = torch.cat([s, d]), torch.cat([d, s]), torch.cat([w, w])
        keep = s != d
        s, d, w = s[keep], d[keep], w[keep]
        del keep
        # Sorted edge keys u * n + v, every copy kept, the least weight
        # first among an edge's copies (sorted by weight, then stably by
        # key): the CSR, and a table in which an edge's least weight is
        # looked up by binary search.
        by_w = torch.argsort(w, stable=True)
        self.keys, order = torch.sort((s * n + d)[by_w], stable=True)
        self.w = w[by_w][order]
        del s, d, w, by_w, order
        self.n, self.device = n, device
        self.col = self.keys % n
        self.rowptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
        torch.cumsum(torch.bincount(self.keys // n, minlength=n), 0,
                     out=self.rowptr[1:])
        self.num_edges = int(self.keys.numel())
        self._comp = None
        self._dist: dict = {}

    # Over the same CSR fields, the BFS reference's: each vertex's
    # component (for the roots rule) and each root's work.
    degrees = _bfs.Reference.degrees
    components = _bfs.Reference.components
    work = _bfs.Reference.work

    def distances(self, root: int, *, dtype: torch.dtype = torch.float32,
                  weights: torch.Tensor = None, rounds: int = -1):
        """(n,) distances from ``root`` in ``dtype`` (+inf where
        unreached) by Bellman-Ford, and the rounds that lowered a
        distance: each round relaxes the out-edges of the vertices the
        last one lowered (the root at first), ``d[v] = min(d[v], d[u] +
        w)`` by a scatter of ``amin``, until a round lowers nothing, or
        until ``rounds`` rounds have lowered one where that is not
        negative. ``weights``: the edge values to add (default: this
        graph's, in ``dtype``)."""
        n, dev = self.n, self.device
        w = self.w.to(dtype) if weights is None else weights
        d = torch.full((n,), math.inf, dtype=dtype, device=dev)
        d[root] = 0.0
        front = torch.tensor([root], device=dev)
        done = 0
        while front.numel() and done != rounds:
            starts = self.rowptr[front]
            cnt = self.rowptr[front + 1] - starts
            total = int(cnt.sum())
            if total == 0:
                break
            first = torch.cumsum(cnt, 0) - cnt
            idx = torch.repeat_interleave(starts - first, cnt,
                                          output_size=total)
            idx += torch.arange(total, device=dev)
            cand = torch.repeat_interleave(d[front], cnt, output_size=total)
            cand += w[idx]
            new = d.scatter_reduce(0, self.col[idx], cand, "amin")
            del idx, cand
            front = torch.nonzero(new < d).squeeze(1)
            d = new
            done += bool(front.numel())
        return d, done

    def _exact(self, root: int) -> tuple:
        """The float32 and float64 distances from ``root``, kept for the
        answers of the same root."""
        if root not in self._dist:
            self._dist[root] = (self.distances(root)[0],
                                self.distances(root, dtype=torch.float64)[0])
        return self._dist[root]

    def _edge(self, u: torch.Tensor, v: torch.Tensor):
        """(exists, position) of the edges u -> v in the CSR: the first,
        least weighted copy. Where any copy meets ``fl(d[u] + w) ==
        d[v]`` at the fixpoint, this one does."""
        key = u * self.n + v
        pos = torch.searchsorted(self.keys, key).clamp_(max=self.num_edges - 1)
        return self.keys[pos] == key, pos

    def tree(self, root: int, d: torch.Tensor,
             weights: torch.Tensor = None) -> torch.Tensor:
        """A valid tree for exact distances ``d``: a breadth-first search
        from ``root`` over the tight edges (``fl(d[u] + w) == d[v]``),
        each vertex taking the largest tight in-neighbour of the level
        before it. Every reached vertex has a tight in-neighbour that
        held its distance before it did, so the search reaches them all.
        Vertices it does not reach (distances no relaxation produced)
        take -1."""
        n, dev = self.n, self.device
        w = self.w if weights is None else weights
        row = torch.repeat_interleave(torch.arange(n, device=dev),
                                      self.degrees())
        tight = torch.isfinite(d[row]) & (d[row] + w == d[self.col])
        row, col = row[tight], self.col[tight]
        preds = torch.full((n,), -1, dtype=torch.int64, device=dev)
        seen = torch.zeros(n, dtype=torch.bool, device=dev)
        front = torch.zeros(n, dtype=torch.bool, device=dev)
        seen[root] = front[root] = True
        while bool(front.any()):
            step = front[row] & ~seen[col]
            preds.scatter_reduce_(0, col[step], row[step], "amax")
            front = torch.zeros_like(seen)
            front[col[step]] = True
            seen |= front
        return preds.to(torch.int32)

    def judge(self, root: int, answer: dict) -> dict:
        """Counts of what ``answer`` (``distances`` and ``preds``, host
        arrays) gets wrong against this reference's search from
        ``root`` (:data:`LIMITS` gives what a correct run may have), and
        the reading ``dist_rel_err``, the answer's largest relative
        distance error against the float64 Bellman-Ford."""
        n, dev = self.n, self.device
        ref, ref64 = self._exact(root)
        reached = torch.isfinite(ref)
        dist = answer.get("distances")
        rel = math.inf
        if dist is None or np.shape(dist) != (n,):
            mismatch = n
        else:
            got = torch.as_tensor(np.asarray(dist, np.float32), device=dev)
            mismatch = int((got.view(torch.int32)
                            != ref.view(torch.int32)).sum())
            if torch.equal(torch.isfinite(got), reached):
                # 0 / 0 where both are 0 (the root, weight-0 paths) is no
                # error; an error over 0 is infinite.
                rel = float(((got.double() - ref64).abs() / ref64)[reached]
                            .nan_to_num(nan=0.0, posinf=math.inf).max())
        preds = answer.get("preds")
        if preds is None or np.shape(preds) != (n,):
            return {"dist_mismatch": mismatch, "bad_pred": n, "not_tree": n,
                    "dist_rel_err": rel}
        p = torch.as_tensor(np.asarray(preds), device=dev).long()
        bad = int((p[~reached] != -1).sum())
        bad += int(p[root].item() not in (-1, root))
        v = torch.nonzero(reached).squeeze(1)
        v = v[v != root]
        pv = p[v]
        inside = (pv >= 0) & (pv < n)
        pc = pv.clamp(0, n - 1)
        exists, pos = self._edge(pc, v)
        ok = inside & exists & (ref[pc] + self.w[pos] == ref[v])
        bad += int((~ok).sum())
        # The tree: every reached vertex's chain of preds ends at the
        # root. Pointer doubling over the preds, a link out of range or
        # from an unreached vertex going to a sink (slot n), the root to
        # itself: after 2^k >= n + 1 links a chain that reaches the root
        # stays there, and one caught in a cycle never gets there.
        up = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
        up[v] = torch.where(inside, pv, n)
        up[root] = root
        for _ in range(max(1, math.ceil(math.log2(n + 1))) + 1):
            up = up[up]
        not_tree = int((up[v] != root).sum())
        return {"dist_mismatch": mismatch, "bad_pred": bad,
                "not_tree": not_tree, "dist_rel_err": rel}

    def control(self, root: int, variant: str) -> dict:
        """The reference in the program's place with one guarantee
        broken: ``one_round_short`` stops one round before the last
        round that lowered a distance; ``bf16_weights`` adds the weights
        rounded to bfloat16, a lower precision than the configuration's
        float32 (a tree over those weights); ``no_tree`` gives exact
        distances and no preds; ``swapped_tie`` gives exact distances
        and this reference's tree with one pair of equally far
        neighbours pointed at each other, each an in-edge meeting the
        equality, so that only the tree check can see it (where the
        graph has no such pair, a vertex and its parent, which the pred
        check sees too, a cycle all the same)."""
        d, rounds = self.distances(root)
        w = None
        if variant == "one_round_short":
            d, _ = self.distances(root, rounds=max(0, rounds - 1))
        elif variant == "bf16_weights":
            w = self.w.to(torch.bfloat16).float()
            d, _ = self.distances(root, weights=w)
        elif variant not in ("no_tree", "swapped_tie"):
            raise ValueError(f"unknown control {variant!r}")
        if variant == "no_tree":
            preds = torch.full((self.n,), -1, dtype=torch.int32,
                               device=self.device)
        else:
            preds = self.tree(root, d, w)
        if variant == "swapped_tie":
            u, v = self._tie(root, d, preds)
            preds[u], preds[v] = v, u
        return {"distances": d.cpu().numpy(), "preds": preds.cpu().numpy()}

    def _tie(self, root: int, d: torch.Tensor, preds: torch.Tensor):
        """A pair (u, v) of equally far reached vertices, neither the
        root, joined both ways by edges meeting the equality; else a
        vertex v of the tree and its parent u, not the root where the
        tree has a deeper vertex."""
        n = self.n
        row = torch.repeat_interleave(torch.arange(n, device=self.device),
                                      self.degrees())
        du, dv = d[row], d[self.col]
        eq = (torch.isfinite(du) & (du == dv) & (du + self.w == dv)
              & (row != root) & (self.col != root))
        u, v = row[eq], self.col[eq]
        both, pos = self._edge(v, u)
        both &= d[v] + self.w[pos] == d[u]
        if bool(both.any()):
            i = int(torch.nonzero(both)[0])
            return int(u[i]), int(v[i])
        child = (preds >= 0) & (preds != root)
        if not bool(child.any()):
            child = preds >= 0
        v = int(torch.nonzero(child)[0])
        return int(preds[v]), v
