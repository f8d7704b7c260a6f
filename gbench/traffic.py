"""The one generator of traffic: the queries of a cell from its traffic
file and ``--seed``.

A traffic file (``traffic/<name>.json``) holds parameters only:

Every mix is a closed loop of one caller: the next query is sent when the
last one returns.

- ``build``, ``upload``, ``entry``: the program's calls, as dotted names
  with keyword arguments (see ``harness.py``).
- ``roots``: the root rule. ``"nonzero_degree"`` draws ``count``
  distinct vertices of nonzero degree (self-loops not counted) from the
  seed; the window cycles through them in the order drawn. With
  ``"outside_largest": k`` it draws ``k`` of them outside the largest
  connected component and the rest inside it, in an order drawn from
  the seed, so that every seed sends the same mix of whole-graph and
  small-component searches.
- ``work``: the rule by which the reference counts a query's work.
- ``reference``: the plain reference, ``reference/<name>.py``.
- ``check``: ``roots``, how many of the distinct roots the window served
  have an answer compared, drawn from the seed where it served more;
  each such root's answer is drawn from the seed among its queries. The
  longest query's answer is compared besides.
- ``trace``: ``queries``, the whole queries of the traced stretch,
  ``label_queries``, those of the stretch whose host operators are
  recorded, and ``spans``, the program's functions the benchmark wraps
  in spans there (see ``trace.py``).
"""

from __future__ import annotations

import numpy as np

# Streams of the seed, one a use, so that one use never shifts another.
ROOTS, CHECK = 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream])


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
    """The answers to compare: one for each of ``roots`` distinct roots
    of those offered (all where fewer were offered), each drawn from the
    seed among the root's answers, and the longest query's besides."""

    def __init__(self, roots: int, seed: int):
        self.roots = roots
        self.rng = rng(seed, CHECK)
        self.kept: dict = {}      # root -> [answers offered, item kept]
        self.longest = None

    def offer(self, wall: float, root: int, item) -> None:
        if self.longest is None or wall > self.longest[0]:
            self.longest = (wall, item)
        slot = self.kept.setdefault(root, [0, None])
        slot[0] += 1
        if int(self.rng.integers(0, slot[0])) == 0:
            slot[1] = item

    def items(self) -> list:
        """The answers to compare, the longest query's among them once."""
        served = list(self.kept)
        if len(served) > self.roots:
            pick = self.rng.choice(len(served), size=self.roots,
                                   replace=False)
            served = [served[i] for i in sorted(pick)]
        out = [self.kept[r][1] for r in served]
        if self.longest is not None and not any(
                it is self.longest[1] for it in out):
            out.append(self.longest[1])
        return out
