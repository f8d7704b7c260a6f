"""Plain BFS reference: its own CSR, components and searches, in PyTorch.

It takes the benchmark's COO and nothing that the program built: it
symmetrizes an undirected graph, drops self-loops and duplicate edges,
sorts, and searches level by level. It imports nothing of the program.

The guarantee it holds a BFS answer to (the configurations state it):
every vertex's label is its hop depth from the root (-1 where
unreached), and the predecessors form a valid tree: each reached vertex
but the root names a neighbour one level up, the root names none (-1)
or itself, and an unreached vertex names none.
"""

from __future__ import annotations

import numpy as np
import torch

# What judge() counts, and the most of each a correct run may have.
LIMITS = {"label_mismatch": 0, "bad_pred": 0}
# The control variants (Reference.control), each of which must fail.
CONTROLS = ("no_tree", "one_level_short")


class Reference:
    def __init__(self, num_nodes: int, src: np.ndarray, dst: np.ndarray, *,
                 undirected: bool, device: torch.device):
        n = int(num_nodes)
        s = torch.from_numpy(np.asarray(src)).to(device, torch.int64)
        d = torch.from_numpy(np.asarray(dst)).to(device, torch.int64)
        if undirected:
            s, d = torch.cat([s, d]), torch.cat([d, s])
        keep = s != d
        # Sorted, distinct edge keys u * n + v: the CSR, and a table in
        # which an edge is looked up by binary search.
        self.keys = torch.unique(s[keep] * n + d[keep])
        del s, d, keep
        self.n, self.device = n, device
        self.col = self.keys % n
        self.rowptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
        torch.cumsum(torch.bincount(self.keys // n, minlength=n), 0,
                     out=self.rowptr[1:])
        self.num_edges = int(self.keys.numel())
        self._comp = None

    def degrees(self) -> torch.Tensor:
        return self.rowptr[1:] - self.rowptr[:-1]

    def components(self) -> torch.Tensor:
        """Each vertex's component, named by its least vertex: stars
        hook onto their least neighbouring star, then pointer jumping,
        until no edge joins two stars."""
        if self._comp is not None:
            return self._comp
        n = self.n
        row = torch.repeat_interleave(
            torch.arange(n, device=self.device), self.degrees())
        parent = torch.arange(n, device=self.device)
        while True:
            pu, pv = parent[row], parent[self.col]
            new = parent.scatter_reduce(0, torch.maximum(pu, pv),
                                        torch.minimum(pu, pv), "amin")
            while True:
                nxt = new[new]
                if torch.equal(nxt, new):
                    break
                new = nxt
            if torch.equal(new, parent):
                break
            parent = new
        self._comp = parent
        return parent

    def work(self, rule: str, roots) -> list[int]:
        """Each root's work by ``rule``. ``component_out_degree_sum``:
        the out-degrees summed over the root's connected component, the
        edges a BFS from it traverses (Gunrock's DOBFS accounting,
        ``util/info.cuh:1431``; the Graph500 TEPS count)."""
        if rule != "component_out_degree_sum":
            raise ValueError(f"unknown work rule {rule!r}")
        comp = self.components()
        total = torch.zeros(self.n, dtype=torch.int64, device=self.device)
        total.scatter_add_(0, comp, self.degrees())
        r = torch.as_tensor(np.asarray(roots), device=self.device).long()
        return total[comp[r]].tolist()

    def search(self, root: int, max_depth: int = -1) -> torch.Tensor:
        """(n,) int32 hop depths from ``root``, -1 where unreached; with
        ``max_depth`` >= 0, no deeper than that."""
        n, dev = self.n, self.device
        labels = torch.full((n,), -1, dtype=torch.int32, device=dev)
        labels[root] = 0
        frontier = torch.tensor([root], device=dev)
        depth = 0
        while frontier.numel() and depth != max_depth:
            starts = self.rowptr[frontier]
            cnt = self.rowptr[frontier + 1] - starts
            total = int(cnt.sum())
            if total == 0:
                break
            first = torch.cumsum(cnt, 0) - cnt
            idx = torch.repeat_interleave(starts - first, cnt,
                                          output_size=total)
            idx += torch.arange(total, device=dev)
            hit = torch.zeros(n, dtype=torch.bool, device=dev)
            hit[self.col[idx]] = True
            new = hit & (labels < 0)
            depth += 1
            labels[new] = depth
            frontier = new.nonzero().squeeze(1)
        return labels

    def tree(self, labels: torch.Tensor) -> torch.Tensor:
        """A valid predecessor array for ``labels``: each labelled vertex
        but the root takes its largest neighbour one level up."""
        n, dev = self.n, self.device
        row = torch.repeat_interleave(
            torch.arange(n, device=dev), self.degrees())
        lab = labels.long()
        up = (lab[row] >= 0) & (lab[row] == lab[self.col] - 1)
        preds = torch.full((n,), -1, dtype=torch.int64, device=dev)
        preds.scatter_reduce_(0, self.col[up], row[up], "amax")
        return preds.to(torch.int32)

    def judge(self, root: int, answer: dict) -> dict:
        """Counts of what ``answer`` (``labels`` and ``preds``, host
        arrays) gets wrong against this reference's search from
        ``root``; :data:`LIMITS` gives what a correct run may have."""
        n, dev = self.n, self.device
        ref = self.search(root)
        labels = answer.get("labels")
        if labels is None or np.shape(labels) != (n,):
            mismatch = n
        else:
            got = torch.as_tensor(np.asarray(labels), device=dev)
            mismatch = int((got.long() != ref.long()).sum())
        preds = answer.get("preds")
        if preds is None or np.shape(preds) != (n,):
            return {"label_mismatch": mismatch, "bad_pred": n}
        p = torch.as_tensor(np.asarray(preds), device=dev).long()
        reached = ref >= 0
        bad = int((p[~reached] != -1).sum())
        bad += int(p[root].item() not in (-1, root))
        v = torch.nonzero(reached).squeeze(1)
        v = v[v != root]
        pv = p[v]
        inside = (pv >= 0) & (pv < n)
        pc = pv.clamp(0, n - 1)
        key = pc * n + v
        pos = torch.searchsorted(self.keys, key).clamp_(max=self.num_edges - 1)
        ok = inside & (ref[pc] == ref[v] - 1) & (self.keys[pos] == key)
        bad += int((~ok).sum())
        return {"label_mismatch": mismatch, "bad_pred": bad}

    def control(self, root: int, variant: str) -> dict:
        """The reference in the program's place with one guarantee
        broken: ``no_tree`` gives exact labels and no predecessors;
        ``one_level_short`` stops one level before the last, with a
        valid tree over what it reached."""
        if variant == "no_tree":
            labels = self.search(root)
            preds = torch.full_like(labels, -1)
        elif variant == "one_level_short":
            full = self.search(root)
            labels = self.search(root, max_depth=max(0, int(full.max()) - 1))
            preds = self.tree(labels)
        else:
            raise ValueError(f"unknown control {variant!r}")
        return {"labels": labels.cpu().numpy(), "preds": preds.cpu().numpy()}
