"""The one generator of traffic: the queries of a cell from its traffic
file and ``--seed``.

A traffic file (``traffic/<name>.json``) holds parameters only:

Every mix is a closed loop of one caller: the next query is sent when the
last one returns.

- ``build``, ``upload``, ``entry``: the program's calls, as dotted names
  with keyword arguments (see ``harness.py``).
- ``roots``: the root rule, or null for a whole-graph entry that takes
  no root (its one root is then None, and every query the same call).
  ``"nonzero_degree"`` draws ``count`` distinct vertices of nonzero
  degree (self-loops not counted) from the seed; the window cycles
  through them in the order drawn. With ``"outside_largest": k`` it
  draws ``k`` of them outside the largest connected component and the
  rest inside it, in an order drawn from the seed, so that every seed
  sends the same mix of whole-graph and small-component searches.
- ``work``: the rule by which the reference counts each root's work.
- ``reference``: the plain reference, ``reference/<name>.py``.
- ``check``: ``roots`` (default 1), how many of the distinct roots the
  window served have answers compared, drawn from the seed where it
  served more, and ``answers`` (default 1), how many of each such
  root's answers, drawn from the seed among its queries. The longest
  query's answer is compared besides (:class:`Sample`). A rootless mix
  has one root, None, so ``answers`` is how many of the window's
  answers are compared.
- ``trace``: ``queries``, the whole queries of the traced stretch,
  ``label_queries``, those of the stretch whose host operators are
  recorded, and ``spans``, the program's functions the benchmark wraps
  in spans there (see ``trace.py``).
"""

from __future__ import annotations

import numpy as np
import torch

# Streams of the seed, one a use, so that one use never shifts another.
ROOTS, CHECK, VALUES = 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream])


def edge_values(rule: dict, num_edges: int, seed: int,
                device: torch.device) -> np.ndarray:
    """A configuration's ``edge_values``: ``num_edges`` float32 values,
    one a generated COO edge, drawn on ``device`` from the seed's
    :data:`VALUES` stream. ``"uniform"`` draws from [``lo``, ``hi``)."""
    if rule["rule"] != "uniform":
        raise ValueError(f"unknown edge value rule {rule['rule']!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng(seed, VALUES).integers(2**63)))
    lo, hi = float(rule["lo"]), float(rule["hi"])
    vals = torch.rand(num_edges, generator=gen, device=device)
    return (lo + (hi - lo) * vals).cpu().numpy()


def degrees(num_nodes: int, src: np.ndarray, dst: np.ndarray,
            undirected: bool) -> np.ndarray:
    """Out-degree of each vertex in the COO, self-loops left out, both
    directions where the graph is undirected (duplicates counted: only
    zero or nonzero is read)."""
    keep = src != dst
    deg = np.bincount(src[keep], minlength=num_nodes)
    if undirected:
        deg += np.bincount(dst[keep], minlength=num_nodes)
    return deg


def draw_roots(rule: dict, graph: dict, undirected: bool, seed: int,
               components: np.ndarray = None) -> np.ndarray:
    """The roots of a run, by the traffic file's ``roots`` rule
    (``components``: each vertex's component, where the rule needs
    them)."""
    if rule["rule"] != "nonzero_degree":
        raise ValueError(f"unknown root rule {rule['rule']!r}")
    deg = degrees(graph["num_nodes"], graph["src"], graph["dst"], undirected)
    cand = np.flatnonzero(deg > 0)
    count, gen = int(rule["count"]), rng(seed, ROOTS)
    if "outside_largest" in rule:
        comp = components[cand]
        ids, sizes = np.unique(comp, return_counts=True)
        inside = comp == ids[np.argmax(sizes)]
        k = int(rule["outside_largest"])
        roots = np.concatenate([_choose(gen, cand[inside], count - k),
                                _choose(gen, cand[~inside], k)])
        return gen.permutation(roots)
    return _choose(gen, cand, count)


def _choose(gen: np.random.Generator, cand: np.ndarray,
            count: int) -> np.ndarray:
    if cand.size < count:
        raise ValueError(f"{cand.size} candidate roots, {count} wanted")
    return gen.choice(cand, size=count, replace=False)


class Sample:
    """The answers to compare: ``answers`` for each of ``roots`` distinct
    roots of those offered (all where fewer were offered), each drawn
    from the seed among the root's answers (a reservoir: every answer
    offered is kept with equal chance, whatever the window's length),
    and the longest query's besides. A rootless mix offers every answer
    under its one root, None."""

    def __init__(self, roots: int, seed: int, answers: int = 1):
        self.roots, self.answers = roots, answers
        self.rng = rng(seed, CHECK)
        self.kept: dict = {}      # root -> [answers offered, items kept]
        self.longest = None

    def offer(self, wall: float, root, item) -> None:
        if self.longest is None or wall > self.longest[0]:
            self.longest = (wall, item)
        slot = self.kept.setdefault(root, [0, []])
        slot[0] += 1
        i = int(self.rng.integers(0, slot[0]))
        if len(slot[1]) < self.answers:
            slot[1].append(item)
        elif i < self.answers:
            slot[1][i] = item

    def items(self) -> list:
        """The answers to compare, the longest query's among them once."""
        served = list(self.kept)
        if len(served) > self.roots:
            pick = self.rng.choice(len(served), size=self.roots,
                                   replace=False)
            served = [served[i] for i in sorted(pick)]
        out = [it for r in served for it in self.kept[r][1]]
        if self.longest is not None and not any(
                it is self.longest[1] for it in out):
            out.append(self.longest[1])
        return out
