"""Graph partitioning for the shard mesh.

Counterpart of :mod:`gunrock_tpu.parallel.partition` (the reference's
``gunrock/app/partitioner_base.cuh`` and ``app/{rp,brp,cp,sp,metisp,
dup}/``). Every method is a **relabeling permutation**: vertices are
renumbered so that shard ``i`` owns the contiguous range ``[i*S,
(i+1)*S)``, so ``owner(v) = v // S`` is arithmetic and the per-shard CSRs
stack into dense ``(p, S+1)`` / ``(p, E_shard)`` tensors.

The assignment methods are the JAX package's numpy code, copied (the
same numpy generators from the same seeds, so ``perm`` is equal bit for
bit): "static", "random" (the default), "biasrandom", "cluster",
"metis" (multilevel coarsen / label propagation / refine), "lp" and
"duplicate" (the identity, as "static"; ``parallel.replicate`` runs the
replicated mode). The relabeled edges are sorted, stacked and given their
ghost tables with torch on the mesh's device, the same integer
operations as the JAX package's numpy build, so every stacked array
equals its JAX counterpart; on the card the flagship's two edge sorts
and ghost builds take a fraction of a second.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graph.csr import CsrGraph
from ..graph.device import resolve_device, round_up
from ..ops.segment import row_reduce_sorted

__all__ = ["PartitionedGraph", "partition", "make_permutation", "for_mesh",
           "label_propagation", "multilevel_partition",
           "boundary_fraction"]

_ARRAYS = ("row_offsets", "col_indices", "edge_values", "csc_offsets",
           "csc_indices", "csc_edge_values", "csc_local", "ghost_send_idx",
           "col_local", "fwd_ghost_send_idx")
_META = ("num_nodes", "num_edges", "num_shards", "shard_size",
         "e_shard_pad", "ghost_cap", "fwd_ghost_cap")
_FLOATS = ("edge_values", "csc_edge_values")


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Vertex-sharded CSR in relabeled id space, stacked on a leading
    shard axis, every tensor on one device: every shard, or one shard
    (a rank of a process-group mesh, :meth:`shard`).

    Shard ``i`` owns relabeled vertices ``[i*shard_size,
    (i+1)*shard_size)`` and stores the CSR rows of exactly those
    vertices; ``col_indices`` are *global relabeled* ids. Offsets are
    shard-local int32. The CSC arrays have a width of their own (the
    largest shard's in-edge count, padded), which may differ from
    ``e_shard_pad``.

    Ghost tables (``partition(with_ghosts=True)``): per (consumer ``i``,
    producer ``j``) the sorted boundary set ``G_ij`` of j-owned vertices
    among i's in-neighbours. ``csc_local`` remaps ``csc_indices`` into
    the compact value-table space ``[own 0..S) | ghosts of peer 0 |
    ghosts of peer 1 | ...]``, ``ghost_send_idx[j, i]`` lists the local
    ids j sends to i, so that a boundary exchange lands every value in
    its slot; ``col_local`` and ``fwd_ghost_send_idx`` do the same for
    the out-neighbours over ``col_indices`` (CC's hooks, BC's backward
    sweep, the forward sweeps of HITS, SALSA and WTF).
    """

    num_nodes: int        # original vertex count
    num_edges: int
    num_shards: int
    shard_size: int       # S, multiple of 128; global padded V = p * S
    e_shard_pad: int      # per-shard edge capacity of the CSR
    row_offsets: torch.Tensor    # (p, S+1) int32, local edge offsets
    col_indices: torch.Tensor    # (p, e_shard_pad) int32 global ids
    edge_values: Optional[torch.Tensor]   # (p, e_shard_pad) float32
    csc_offsets: Optional[torch.Tensor]   # (p, S+1) inverse CSR
    csc_indices: Optional[torch.Tensor]   # (p, e_csc) global sources
    csc_edge_values: Optional[torch.Tensor]
    csc_local: Optional[torch.Tensor] = None       # (p, e_csc) int32
    ghost_send_idx: Optional[torch.Tensor] = None  # (p, p, ghost_cap)
    ghost_cap: int = 0
    col_local: Optional[torch.Tensor] = None       # (p, e_shard_pad) int32
    fwd_ghost_send_idx: Optional[torch.Tensor] = None
    fwd_ghost_cap: int = 0
    # The first shard held: 0, or the shard a rank of a process-group
    # mesh holds (:meth:`shard`). The one field the JAX
    # ``PartitionedGraph`` lacks: it always holds every shard.
    shard_lo: int = 0

    @property
    def v_global_pad(self) -> int:
        return self.num_shards * self.shard_size

    @property
    def local_shards(self) -> int:
        """The shards held: the length of every array's leading axis."""
        return self.row_offsets.shape[0]

    def shard(self, i: int) -> "PartitionedGraph":
        """Shard ``i`` alone, as a rank of a process-group mesh holds it:
        row ``i`` of every stacked array (copies, so the rest can be
        freed), with ``ghost_send_idx[i]`` the tables of what ``i`` sends
        each peer."""
        if self.local_shards != self.num_shards:
            raise ValueError("shard() slices a partition holding every "
                             "shard")
        kw = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(self)}
        for k in _ARRAYS:
            if kw[k] is not None:
                kw[k] = kw[k][i:i + 1].clone()
        kw["shard_lo"] = int(i)
        return PartitionedGraph(**kw)

    @property
    def has_ghosts(self) -> bool:
        return self.csc_local is not None

    @property
    def device(self) -> torch.device:
        return self.row_offsets.device

    @classmethod
    def from_numpy(cls, fields: dict, device="cuda",
                   shard: Optional[int] = None) -> "PartitionedGraph":
        """Build a partitioned graph from its fields as numpy arrays (and
        ints): the JAX ``PartitionedGraph``'s arrays, read with
        ``np.asarray``, carried across unchanged, so that both packages'
        ``*_sharded_device`` functions can run on one partition. Arrays
        take their dtype here (int32 ids and offsets, float32 values);
        absent or None fields stay None. ``shard``: keep that shard's row
        of every array alone, as a rank of a process-group mesh holds it
        (:meth:`shard`)."""
        dev = resolve_device(device)
        kw = {k: int(fields.get(k) or 0) for k in _META}
        for k in _ARRAYS:
            a = fields.get(k)
            if a is None:
                kw[k] = None
                continue
            if shard is not None:
                a = np.asarray(a)[shard:shard + 1]
            a = np.ascontiguousarray(
                a, dtype=np.float32 if k in _FLOATS else np.int32)
            # a JAX array read with np.asarray is read-only
            kw[k] = torch.from_numpy(
                a if a.flags.writeable else a.copy()).to(dev)
        return cls(**kw, shard_lo=0 if shard is None else int(shard))


def for_mesh(pg: PartitionedGraph, mesh) -> PartitionedGraph:
    """The shards of ``pg`` that ``mesh`` holds here: all of them on the
    stacked mesh, the rank's own on a process-group mesh (every rank
    runs the same seeded partition and keeps its row)."""
    return pg.shard(mesh.shard_lo) if mesh.distributed else pg


def _expand_frontier(row: np.ndarray, col: np.ndarray,
                     frontier: np.ndarray) -> np.ndarray:
    """All neighbors of ``frontier`` (with duplicates), fully vectorized:
    the numpy equivalent of one CSR advance (multi-slice gather)."""
    starts = row[frontier]
    counts = row[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=col.dtype)
    # offsets[i] = position of frontier[i]'s first edge in the output
    offs = np.zeros(len(frontier), dtype=np.int64)
    np.cumsum(counts[:-1], out=offs[1:])
    eids = np.arange(total, dtype=np.int64) + np.repeat(starts - offs, counts)
    return col[eids]


def _bfs_order(g: CsrGraph) -> np.ndarray:
    """Vectorized BFS traversal order (per-level numpy advance; remaining
    components are seeded together in one multi-source sweep)."""
    n = g.num_nodes
    row = g.row_offsets.astype(np.int64)
    col = g.col_indices.astype(np.int64)
    order = np.empty(n, dtype=np.int64)
    seen = np.zeros(n, dtype=bool)
    k = 0
    root = int(g.out_degrees.argmax()) if n else 0
    frontier = np.array([root], dtype=np.int64)
    seen[root] = True
    for phase in range(2):
        while frontier.size:
            order[k:k + frontier.size] = frontier
            k += frontier.size
            nbrs = _expand_frontier(row, col, frontier)
            nbrs = nbrs[~seen[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)
            seen[nbrs] = True
            frontier = nbrs
        if phase == 0:
            # Seed every remaining component at once (their traversals
            # interleave, but each component's vertices stay contiguous
            # enough for chunked sharding).
            frontier = np.nonzero(~seen)[0]
            seen[frontier] = True
    return order[:k] if k == n else np.concatenate(
        [order[:k], np.nonzero(~seen)[0]])


def _group_rank(keys: np.ndarray) -> np.ndarray:
    """rank of each element within its key group (vectorized groupby)."""
    n = keys.shape[0]
    srt = np.lexsort((np.arange(n), keys))
    sk = keys[srt]
    is_start = np.r_[True, sk[1:] != sk[:-1]]
    group_start = np.maximum.accumulate(
        np.where(is_start, np.arange(n), 0))
    out = np.empty(n, dtype=np.int64)
    out[srt] = np.arange(n) - group_start
    return out


def _lp_refine(src: np.ndarray, dst: np.ndarray, ew: np.ndarray,
               nw: np.ndarray, num_shards: int, cap_w: float,
               lab: np.ndarray, rounds: int) -> np.ndarray:
    """Weighted label-propagation move rounds (the shared engine behind
    :func:`label_propagation` and the multilevel refinement): every vertex
    scores each shard by its edge-weight to it with a Fennel-style
    occupancy penalty, then the highest-gain moves are accepted per target
    shard up to its remaining node-weight capacity. All edge-scale work is
    ``np.bincount``; acceptance is a per-target segmented cumsum."""
    n = nw.shape[0]
    p = num_shards
    lab = lab.copy()
    lane = np.arange(n)
    for _ in range(rounds):
        counts = np.bincount(src * p + lab[dst], weights=ew,
                             minlength=n * p).reshape(n, p)
        sizes = np.bincount(lab, weights=nw, minlength=p)
        score = counts * (1.0 - sizes / (2.0 * cap_w))
        want = score.argmax(axis=1)
        gain = score[lane, want] - score[lane, lab]
        cand = np.nonzero((want != lab) & (gain > 0))[0]
        if cand.size == 0:
            break
        # accept per target shard in gain order up to remaining capacity
        # (node-weight units): segmented inclusive cumsum of move weights
        order = np.lexsort((-gain[cand], want[cand]))
        cs = cand[order]
        tgt = want[cs]
        w = nw[cs].astype(np.float64)
        cum = np.cumsum(w)
        is_start = np.r_[True, tgt[1:] != tgt[:-1]]
        seg_first = np.maximum.accumulate(
            np.where(is_start, np.arange(len(cs)), 0))
        cum_in_seg = cum - (cum - w)[seg_first]
        room = np.maximum(cap_w - sizes[tgt], 0.0)
        ok = cs[cum_in_seg <= room]
        if ok.size == 0:
            break
        lab[ok] = want[ok]
    return lab


def _rebalance(src: np.ndarray, dst: np.ndarray, ew: np.ndarray,
               nw: np.ndarray, num_shards: int, cap_w: float,
               lab: np.ndarray) -> np.ndarray:
    """Evict the least-attached vertices from overfull shards into the
    emptiest shards (LP move rounds only ever reject inbound moves, so a
    bad initial projection can leave a shard overfull)."""
    n = nw.shape[0]
    p = num_shards
    lab = lab.copy()
    for _ in range(p):
        sizes = np.bincount(lab, weights=nw, minlength=p)
        over = np.nonzero(sizes > cap_w)[0]
        if over.size == 0:
            break
        counts = np.bincount(src * p + lab[dst], weights=ew,
                             minlength=n * p).reshape(n, p)
        for s in over:
            members = np.nonzero(lab == s)[0]
            # least internally attached leave first
            leave = members[np.argsort(counts[members, s], kind="stable")]
            excess = sizes[s] - cap_w
            take = np.searchsorted(np.cumsum(nw[leave]), excess) + 1
            moved = leave[: min(int(take), leave.size)]
            if moved.size == 0:
                continue
            # best target among shards with room, else globally emptiest
            tgt_score = counts[moved].astype(np.float64)
            tgt_score[:, sizes >= cap_w] = -np.inf
            tgt = tgt_score.argmax(axis=1)
            nofit = ~np.isfinite(tgt_score[np.arange(moved.size), tgt])
            tgt[nofit] = sizes.argmin()
            lab[moved] = tgt
            sizes = np.bincount(lab, weights=nw, minlength=p)
    return lab


def _heavy_matching(src: np.ndarray, dst: np.ndarray, ew: np.ndarray,
                    n: int, rng: np.random.Generator,
                    rounds: int = 4) -> np.ndarray:
    """Vectorized heavy-edge matching: each unmatched vertex proposes to
    its heaviest unmatched neighbor; mutual proposals pair up. A few
    proposal rounds reach near-maximal matchings (the role of the serial
    greedy matching in multilevel partitioners)."""
    match = np.full(n, -1, np.int64)
    for _ in range(rounds):
        alive = (match[src] < 0) & (match[dst] < 0) & (src != dst)
        s, d, w = src[alive], dst[alive], ew[alive]
        if s.size == 0:
            break
        # per-source argmax weight (random tiebreak): ascending lexsort,
        # last edge of each source segment is its heaviest
        key = np.lexsort((rng.random(s.size), w, s))
        ss = s[key]
        last = np.r_[ss[1:] != ss[:-1], True]
        prop = np.full(n, -1, np.int64)
        prop[ss[last]] = d[key][last]
        has = prop >= 0
        mutual = has & (prop[np.clip(prop, 0, n - 1)] == np.arange(n)) \
            & (np.arange(n) < prop)
        v = np.nonzero(mutual)[0]
        match[v] = prop[v]
        match[prop[v]] = v
    return match


def _coarsen(src: np.ndarray, dst: np.ndarray, ew: np.ndarray,
             nw: np.ndarray, match: np.ndarray):
    """Contract matched pairs: returns ``(cid, csrc, cdst, cew, cnw)``
    where ``cid[v]`` is v's coarse vertex; parallel coarse edges merge
    with summed weights, self-loops drop (their weight is interior)."""
    n = nw.shape[0]
    parent = np.where(match >= 0, np.minimum(np.arange(n), match),
                      np.arange(n))
    reps, cid = np.unique(parent, return_inverse=True)
    nc = reps.size
    cs, cd = cid[src], cid[dst]
    keep = cs != cd
    key = cs[keep] * np.int64(nc) + cd[keep]
    uk, inv = np.unique(key, return_inverse=True)
    cew = np.bincount(inv, weights=ew[keep])
    cnw = np.bincount(cid, weights=nw, minlength=nc)
    return cid, (uk // nc).astype(np.int64), (uk % nc).astype(np.int64), \
        cew, cnw


def multilevel_partition(g: CsrGraph, num_shards: int, seed: int = 0,
                         slack: float = 1.03,
                         coarsest_rounds: int = 24,
                         refine_rounds: int = 6) -> np.ndarray:
    """Multilevel min-cut partitioning — the real analogue of the
    reference's libmetis call (``METIS_PartGraphKway``,
    ``app/metisp/metis_partitioner.cuh:17``), built from the same three
    phases METIS uses, all vectorized numpy:

      1. **coarsen**: repeated heavy-edge matching + contraction until the
         graph is small (edge weights accumulate merged parallel edges,
         node weights accumulate contracted vertices);
      2. **initial partition**: weighted label propagation on the
         coarsest graph (balanced by node weight);
      3. **uncoarsen + refine**: project labels level by level, running
         boundary move rounds (FM-style highest-gain-first with capacity
         acceptance) at every level.

    Single-level LP (``label_propagation``) remains available as the
    cheap stand-in; this one closes the cut-quality gap on mesh/road
    graphs where local moves alone cannot escape a bad random start.
    """
    n = g.num_nodes
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rng = np.random.default_rng(seed)
    src = g.edge_sources().astype(np.int64)
    dst = g.col_indices.astype(np.int64)
    ew = np.ones(src.shape[0], np.float64)
    nw = np.ones(n, np.float64)
    total_w = float(n)
    coarse_target = max(8 * num_shards, 96)
    levels = []   # (src, dst, ew, nw, cid) per fine level, finest first
    while nw.shape[0] > coarse_target:
        match = _heavy_matching(src, dst, ew, nw.shape[0], rng)
        if np.count_nonzero(match >= 0) < 0.1 * nw.shape[0]:
            break   # matching stalled (star-like residue)
        levels.append((src, dst, ew, nw))
        cid, src, dst, ew, nw = _coarsen(src, dst, ew, nw, match)
        levels[-1] = levels[-1] + (cid,)
    cap_w = slack * total_w / num_shards
    # best-of-K initial partitions at the coarsest level (METIS runs
    # multiple initial bisections the same way) — the coarsest graph is
    # tiny, so extra starts are nearly free
    best_lab, best_cut = None, np.inf
    for _ in range(4):
        lab = rng.integers(0, num_shards, nw.shape[0])
        lab = _lp_refine(src, dst, ew, nw, num_shards, cap_w, lab,
                         coarsest_rounds)
        lab = _rebalance(src, dst, ew, nw, num_shards, cap_w, lab)
        cut = float(ew[lab[src] != lab[dst]].sum())
        if cut < best_cut:
            best_lab, best_cut = lab, cut
    lab = best_lab
    for fsrc, fdst, few, fnw, cid in reversed(levels):
        lab = lab[cid]
        lab = _lp_refine(fsrc, fdst, few, fnw, num_shards, cap_w, lab,
                         refine_rounds)
    # finest-level balance guarantee (the 1.15x test bound): tighten to
    # unit node weights and evict any residual overflow
    fsrc = src if not levels else levels[0][0]
    fdst = dst if not levels else levels[0][1]
    few = ew if not levels else levels[0][2]
    lab = _rebalance(fsrc, fdst, few, np.ones(n, np.float64), num_shards,
                     slack * n / num_shards, lab)
    # Portfolio vs flat LP: on power-law graphs (no good cuts exist)
    # coarsening projects into a worse basin than LP-from-random — a
    # known multilevel weakness on social graphs — so keep whichever
    # labeling measurably cuts less. Both are cheap next to graph build.
    lab_lp = label_propagation(g, num_shards, seed)
    if (few[lab_lp[fsrc] != lab_lp[fdst]].sum()
            < few[lab[fsrc] != lab[fdst]].sum()):
        lab = lab_lp
    return lab


def label_propagation(g: CsrGraph, num_shards: int, seed: int = 0,
                      rounds: int = 8,
                      slack: float = 1.05) -> np.ndarray:
    """Balanced label-propagation partitioning (min-cut stand-in for the
    reference's libmetis-backed partitioner, app/metisp — METIS itself is
    not linkable here, so this plays its role: shrink boundary volume vs
    random while keeping shards balanced).

    Each round every vertex adopts the neighbor-majority shard, scored
    with a Fennel-style occupancy penalty; moves into overfull shards are
    rejected. All edge-scale work is ``np.bincount`` (vectorized).
    """
    n = g.num_nodes
    p = num_shards
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    cap = float(slack * -(-n // p))
    src = g.edge_sources().astype(np.int64)
    dst = g.col_indices.astype(np.int64)
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, p, n)
    return _lp_refine(src, dst, np.ones(src.shape[0], np.float64),
                      np.ones(n, np.float64), p, cap, lab, rounds)


def _from_labels(lab: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(shard_of, slot) from an arbitrary per-vertex shard labeling."""
    return lab.astype(np.int64), _group_rank(lab)


def _assignment(g: CsrGraph, method: str, num_shards: int,
                seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Return ``(shard_of, slot)`` per old vertex id.

    ``shard_of[v]`` is the owner shard; ``slot[v]`` the dense within-shard
    position. All methods produce near-equal shard populations.
    """
    n = g.num_nodes
    chunk = max(-(-n // num_shards), 1)

    def from_order(order: np.ndarray):
        """Contiguous chunks of a global vertex ordering -> shards."""
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.arange(n)
        return rank // chunk, rank % chunk

    if method in ("static", "duplicate"):
        return from_order(np.arange(n, dtype=np.int64))
    if method == "random":
        rng = np.random.default_rng(seed)
        return from_order(rng.permutation(n).astype(np.int64))
    if method == "biasrandom":
        # Degree-balanced: snake-assign vertices by descending degree
        # (reference brp biases assignment by degree,
        # app/brp/brp_partitioner.cuh). Vectorized: shard = snake(rank),
        # slot = occurrence index of that shard in the snake sequence.
        deg = g.out_degrees
        order = np.argsort(-deg, kind="stable")  # heavy vertices first
        cycle = np.arange(n) % (2 * num_shards)
        snake = np.where(cycle < num_shards, cycle,
                         2 * num_shards - 1 - cycle)
        shard_of = np.empty(n, dtype=np.int64)
        slot = np.empty(n, dtype=np.int64)
        shard_of[order] = snake
        slot[order] = _group_rank(snake)
        return shard_of, slot
    if method == "cluster":
        # Locality ordering: BFS traversal order keeps neighborhoods in
        # the same shard (greedy clustering, app/cp analogue).
        return from_order(_bfs_order(g))
    if method == "metis":
        # Multilevel min-cut (coarsen / partition / refine) — the real
        # analogue of the reference's METIS_PartGraphKway call.
        return _from_labels(multilevel_partition(g, num_shards, seed))
    if method == "lp":
        # Single-level balanced label propagation (cheaper stand-in).
        return _from_labels(label_propagation(g, num_shards, seed))
    raise ValueError(f"unknown partition method {method!r}")


def boundary_fraction(g: CsrGraph, shard_of: np.ndarray) -> float:
    """Fraction of edges crossing shards under ``shard_of`` — the metric
    partitioners minimize (reference reports per-GPU in/out counters,
    ``partitioner_base.cuh:473-484``)."""
    if g.num_edges == 0:
        return 0.0
    cross = shard_of[g.edge_sources()] != shard_of[g.col_indices]
    return float(np.count_nonzero(cross)) / g.num_edges


def make_permutation(g: CsrGraph, method: str, num_shards: int,
                     seed: int = 0) -> tuple[np.ndarray, int]:
    """Return ``(perm, shard_size)`` with ``perm[old_id] = new_id``.

    ``new_id = shard_of * shard_size + slot``; ``shard_size`` is padded to
    a lane multiple, so new ids may be sparse (gaps are zero-degree padding
    vertices).
    """
    shard_of, slot = _assignment(g, method, num_shards, seed)
    max_count = int(slot.max(initial=0)) + 1 if g.num_nodes else 1
    S = round_up(max_count)
    return shard_of * S + slot, S


@dataclasses.dataclass(frozen=True)
class FlatRows:
    """Every shard's rows of one stacked CSR or CSC, their real edges
    concatenated in shard order (no padding between shards), so that one
    segmented reduction serves all shards: row ``i * S + v`` spans
    ``offsets[i * S + v] .. offsets[i * S + v + 1]``. ``ids`` index a
    flattened ``(p, width)`` table (``i * width + id``) or, with no
    width, are the global ids themselves."""

    offsets: torch.Tensor   # (p * S + 1,) int64
    ids: torch.Tensor       # (nnz,) int64

    def reduce(self, table: torch.Tensor, op: str) -> torch.Tensor:
        """``(p, S)``: each row's ``op`` (``row_reduce_sorted``: sums
        in float64, the identities on empty rows) of the ``(p, width)``
        ``table`` gathered at its edges' ids."""
        vals = table.reshape(-1)[self.ids]
        return row_reduce_sorted(vals, self.offsets,
                                 op=op).view(table.shape[0], -1)


def flat_rows(offsets: torch.Tensor, ids: torch.Tensor,
              width: Optional[int] = None) -> FlatRows:
    """:class:`FlatRows` of stacked ``(p, S+1)`` local offsets and
    ``(p, E)`` ids."""
    p, e = ids.shape
    dev = ids.device
    ne = offsets[:, -1].long()
    base = torch.cumsum(ne, 0) - ne
    flat = torch.cat([(offsets[:, :-1].long() + base[:, None]).reshape(-1),
                      ne.sum().reshape(1)])
    pos = torch.nonzero((torch.arange(e, device=dev) < ne[:, None])
                        .reshape(-1)).flatten()
    out = ids.reshape(-1)[pos].long()
    if width is not None:
        out = out + (pos // e) * width
    return FlatRows(offsets=flat, ids=out)


def _build_ghost_tables(csc_row: torch.Tensor, csc_col: torch.Tensor,
                        num_shards: int, S: int):
    """Per-(consumer, producer) boundary sets and the local remap of
    ``csc_col`` (``(p, S+1)`` offsets and ``(p, E)`` global ids, or the
    CSR's for the forward tables). Returns ``(csc_local, send_idx,
    ghost_cap)``, see :class:`PartitionedGraph` (reference: ghost
    renumbering and backward tables, ``partitioner_base.cuh:295-340,
    357-383``). Ids are owner-major, so one sorted unique per consumer
    gives every per-producer set already grouped."""
    p = num_shards
    dev = csc_col.device
    ends = csc_row[:, -1].tolist()
    cuts = torch.arange(p + 1, device=dev, dtype=torch.int64) * S
    uniq, seg = [], []
    cap = 1
    for i in range(p):
        srcs = csc_col[i, :ends[i]].long()
        gi = torch.unique(srcs[srcs // S != i], sorted=True)
        bounds = torch.searchsorted(gi, cuts)
        uniq.append(gi)
        seg.append(bounds)
        if gi.numel():
            cap = max(cap, int(torch.diff(bounds).max()))
    ghost_cap = -(-cap // 128) * 128
    send_idx = torch.zeros((p, p, ghost_cap), dtype=torch.int32, device=dev)
    csc_local = torch.zeros_like(csc_col)
    for i in range(p):
        srcs = csc_col[i, :ends[i]].long()
        owner = srcs // S
        gi, bounds = uniq[i], seg[i]
        counts = torch.diff(bounds)
        # producer side: the local ids of shard j's boundary set
        jidx = torch.repeat_interleave(
            torch.arange(p, device=dev), counts, output_size=gi.numel())
        slotidx = torch.arange(gi.numel(), device=dev) - torch.repeat_interleave(
            bounds[:-1], counts, output_size=gi.numel())
        send_idx[jidx, i, slotidx] = (gi - jidx * S).to(torch.int32)
        # consumer side: remote sources -> S + owner * cap + slot
        remote = owner != i
        pos = torch.searchsorted(gi, srcs[remote])
        slot = pos - bounds[:-1][owner[remote]]
        local = srcs - i * S
        local[remote] = S + owner[remote] * ghost_cap + slot
        csc_local[i, :ends[i]] = local.to(torch.int32)
    return csc_local, send_idx, ghost_cap


def _build_stacked(src: torch.Tensor, dst: torch.Tensor,
                   val: Optional[torch.Tensor], num_shards: int, S: int):
    """Stack edges sorted by ``src`` (global relabeled ids) into per-shard
    local offsets ``(p, S+1)``, ids ``(p, E)`` and values, zero-padded to
    the largest shard's edge count rounded up to 128."""
    dev = src.device
    v_pad = num_shards * S
    counts = torch.bincount(src, minlength=v_pad)
    shard_edges = counts.view(num_shards, S).sum(dim=1)
    e_shard = round_up(max(int(shard_edges.max()) if v_pad else 0, 1))
    glob = torch.zeros(v_pad + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=glob[1:])
    starts = glob[torch.arange(num_shards, device=dev) * S]
    row = (torch.cat([glob[:-1].view(num_shards, S),
                      glob[S::S].view(num_shards, 1)], dim=1)
           - starts[:, None]).to(torch.int32)
    shard = src // S
    pos = shard * e_shard + torch.arange(src.shape[0], device=dev) \
        - starts[shard]
    colx = torch.zeros(num_shards * e_shard, dtype=torch.int32, device=dev)
    colx[pos] = dst.to(torch.int32)
    valx = None
    if val is not None:
        valx = torch.zeros(num_shards * e_shard, dtype=torch.float32,
                           device=dev)
        valx[pos] = val
        valx = valx.view(num_shards, e_shard)
    return row, colx.view(num_shards, e_shard), valx


def partition(g: CsrGraph, num_shards: int, *, method: str = "random",
              seed: int = 0, with_csc: bool = False,
              with_edge_values: bool = False, with_ghosts: bool = False,
              device="cuda") -> tuple[PartitionedGraph, np.ndarray]:
    """Partition and relabel ``g`` into ``num_shards`` vertex shards on
    ``device`` (the mesh's).

    Returns ``(pg, perm)`` where ``perm[old] = new``; results computed in
    relabeled space map back via ``out[old] = result[perm[old]]``."""
    dev = resolve_device(device)
    n = g.num_nodes
    perm, S = make_permutation(g, method, num_shards, seed)
    v_pad = num_shards * S

    # Relabel the edges and sort them by (src, dst), stably, as the JAX
    # package's lexsort does: one int64 key, src * v_pad + dst.
    perm_t = torch.from_numpy(perm).to(dev)
    row_offsets = torch.from_numpy(
        np.asarray(g.row_offsets, np.int64)).to(dev)
    col = torch.from_numpy(np.asarray(g.col_indices)).to(dev).long()
    deg = torch.diff(row_offsets)
    src_new = perm_t[torch.repeat_interleave(
        torch.arange(n, device=dev), deg, output_size=g.num_edges)]
    dst_new = perm_t[col]
    del col
    order = torch.sort(src_new * v_pad + dst_new, stable=True).indices
    src_new, dst_new = src_new[order], dst_new[order]
    vals = None
    if with_edge_values:
        ev = g.edge_values
        vals = (torch.ones(g.num_edges, dtype=torch.float32, device=dev)
                if ev is None else
                torch.from_numpy(np.asarray(ev, np.float32)).to(dev)[order])
    del order

    row, colx, valx = _build_stacked(src_new, dst_new, vals, num_shards, S)

    csc_row = csc_col = csc_val = None
    csc_local = send_idx = col_local = fwd_send_idx = None
    ghost_cap = fwd_ghost_cap = 0
    if with_csc or with_ghosts:
        order_t = torch.sort(dst_new * v_pad + src_new, stable=True).indices
        csc_row, csc_col, csc_val = _build_stacked(
            dst_new[order_t], src_new[order_t],
            vals[order_t] if vals is not None else None, num_shards, S)
        del order_t
        if with_ghosts:
            csc_local, send_idx, ghost_cap = _build_ghost_tables(
                csc_row, csc_col, num_shards, S)
            col_local, fwd_send_idx, fwd_ghost_cap = _build_ghost_tables(
                row, colx, num_shards, S)

    pg = PartitionedGraph(
        num_nodes=n, num_edges=g.num_edges, num_shards=num_shards,
        shard_size=S, e_shard_pad=colx.shape[1], row_offsets=row,
        col_indices=colx, edge_values=valx, csc_offsets=csc_row,
        csc_indices=csc_col, csc_edge_values=csc_val, csc_local=csc_local,
        ghost_send_idx=send_idx, ghost_cap=ghost_cap, col_local=col_local,
        fwd_ghost_send_idx=fwd_send_idx, fwd_ghost_cap=fwd_ghost_cap)
    return pg, perm
