"""K7 on the CPU: what ``reduce_by_dst_sorted`` runs on the card
(``reduce_tiles_kernel`` in ``csrc/sssp_kernels.cu``), modelled in numpy
and held against ``ops.kernels.reduce_by_dst_sorted_plain``, and on two
push rounds against the JAX package's Pallas kernel in interpret mode.

One launch walks the stream in tiles of ``REDUCE_TILE`` lanes. In a tile
a warp owns ``ROWS`` rows of 128 lanes and a thread 4 consecutive lanes
of each row: the thread folds its lanes in order, a shuffle scan joins
the threads' last runs, a carry passes from row to row, a scan joins the
warps' last runs, and a tile whose first run began in an earlier tile
and ends in it folds that run's carry in a fixed order: the tail partial
of the tile where the run began, then the head partial of each whole
tile after it. Counts pass between tiles by a decoupled look-back, 32
tiles a step, in whatever order the tiles publish. The model follows
that thread by thread, with the tiles' look-backs in a seeded random
order.

Tolerances: ids, counts and min are exact; the kernel sums in float32
in its order where the plain version sums in float64, so sums carry
rtol 1e-6, as on the card; the JAX comparison keeps
``tests/test_torch_sssp.py``'s rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu.ops.pallas_kernels as pk
import gunrock_tpu_torch as gtt
from gunrock_tpu_torch.ops import kernels as K
from gunrock_tpu_torch.ops.advance import expand
from test_torch_cuda import REDUCE_CASES, reduce_case

TILE = K.REDUCE_TILE
WARPS, ROWS, LANES = 8, 2, 32     # kReduceWarps, kReduceRows in the source
INT_MIN = np.iinfo(np.int32).min
MUTATIONS = ("carry_start", "carry_partial", "rank")


def _comb(op, a, b):
    """``a`` joined before ``b``, in float32, as the kernel's combine."""
    return (a + b).astype(np.float32) if op == "sum" else np.fmin(a, b)


def _scan(op, v, key, width):
    """The kernel's ``run_scan`` along the last axis: a lane joins lane
    - d while their keys agree, for d = 1, 2, 4, ... below ``width``."""
    lane = np.arange(v.shape[-1])
    d = 1
    while d < width:
        o, ok = np.roll(v, d, axis=-1), np.roll(key, d, axis=-1)
        v = np.where((lane >= d) & (ok == key), _comb(op, o, v), v)
        d *= 2
    return v


def _count_lookback(counts, rng):
    """Each tile's exclusive prefix of the counts by the kernel's
    look-back: every tile has published its own count; the tiles then
    look back in a random order, 32 tiles a step, to the nearest that
    has published its inclusive prefix, and publish theirs."""
    nt = counts.shape[0]
    inclusive = {0: int(counts[0])}
    excl = np.zeros(nt, np.int64)
    for c in rng.permutation(np.arange(1, nt)):
        total, base = 0, c - 1
        while True:
            js = base - np.arange(32)
            found = [l for l, j in enumerate(js) if j < 0 or j in inclusive]
            stop = found[0] if found else 31
            for j in js[:stop + 1]:
                if j >= 0:
                    total += inclusive[j] if j in inclusive else counts[j]
            if found:
                break
            base -= 32
        excl[c] = total
        inclusive[c] = total + int(counts[c])
    return excl


def k7_model(sd, vals, aux, *, op, out_lanes, seed=0, mutate=None):
    """(ids, rvals, count) of the card's K7 on numpy inputs; lanes at or
    past the count are 0. ``mutate`` breaks one step (for the test that
    the comparisons catch it): ``carry_start`` starts a run's carry one
    tile late, ``carry_partial`` folds the start tile's head partial for
    its tail partial, ``rank`` counts a lane's own row emits into its
    rank."""
    m = sd.shape[0]
    ids = np.zeros(out_lanes, np.int32)
    rvals = np.zeros(out_lanes, np.float32)
    if m == 0:
        return ids, rvals, 0
    ident = np.float32(0.0 if op == "sum" else np.inf)
    nt = -(-m // TILE)
    e = np.arange(nt * TILE)
    valid = e < m
    key = np.full(nt * TILE, INT_MIN, np.int32)
    key[:m] = sd
    x = np.full(nt * TILE, ident, np.float32)
    x[:m] = vals
    nxt = np.append(key[1:], 0)
    tail = valid & ((e + 1 >= m) | (nxt != key))

    # A warp's rows, a thread's 4 lanes: (tile, warp, row, lane, i) is
    # the stream's own order.
    k5 = key.reshape(nt, WARPS, ROWS, LANES, 4)
    x5 = x.reshape(nt, WARPS, ROWS, LANES, 4).copy()
    for i in range(1, 4):
        same = k5[..., i] == k5[..., i - 1]
        x5[..., i] = np.where(same, _comb(op, x5[..., i - 1], x5[..., i]),
                              x5[..., i])
    lane = np.arange(LANES)
    rc_val = np.full((nt, WARPS), ident, np.float32)
    rc_key = np.zeros((nt, WARPS), np.int32)
    for r in range(ROWS):
        first, last = k5[:, :, r, :, 0], k5[:, :, r, :, 3]
        incl = _scan(op, x5[:, :, r, :, 3], last, 32)
        pk_, pe = np.roll(last, 1, axis=-1), np.roll(incl, 1, axis=-1)
        ex = (lane > 0) & (pk_ == first)
        rc_on = (r > 0) & (rc_key[..., None] == first) & \
            (first[..., :1] == first)
        rcv = np.broadcast_to(rc_val[..., None], pe.shape)
        pre = np.where(ex & rc_on, _comb(op, rcv, pe), np.where(ex, pe, rcv))
        on = (ex | rc_on)[..., None] & (k5[:, :, r] == first[..., None])
        x5[:, :, r] = np.where(on, _comb(op, pre[..., None], x5[:, :, r]),
                               x5[:, :, r])
        rc_val, rc_key = x5[:, :, r, 31, 3], last[..., 31]

    wfirst = k5[:, :, 0, 0, 0]
    ws = _scan(op, rc_val, rc_key, WARPS)
    wc = np.roll(ws, 1, axis=1)
    w_on = (np.arange(WARPS) > 0) & (np.roll(rc_key, 1, axis=1) == wfirst)
    on = w_on[..., None, None, None] & (k5 == wfirst[..., None, None, None])
    x5 = np.where(on, _comb(op, wc[..., None, None, None], x5), x5)

    # The tile's head and tail partials, and the run carries.
    xt, kt = x5.reshape(nt, TILE), key.reshape(nt, TILE)
    et, tt = e.reshape(nt, TILE), tail.reshape(nt, TILE)
    hi = np.minimum((np.arange(nt) + 1) * TILE, m)
    tfirst = kt[:, 0]
    last_lane = et == hi[:, None] - 1
    head_lane = (kt == tfirst[:, None]) & (et < hi[:, None]) & \
        (tt | last_lane)
    assert (head_lane.sum(1) == 1).all() and (last_lane.sum(1) == 1).all()
    headp, tailp = xt[head_lane], xt[last_lane]
    head_ends = ((kt == tfirst[:, None]) & tt).any(1)
    for c in range(1, nt):
        if not (sd[c * TILE - 1] == tfirst[c] and head_ends[c]):
            continue
        s = c - 1
        while s > 0 and sd[s * TILE - 1] == tfirst[c]:
            s -= 1
        if mutate == "carry_start":
            s = min(s + 1, c - 1)
        acc = headp[s] if mutate == "carry_partial" else tailp[s]
        for j in range(s + 1, c):
            acc = _comb(op, acc, headp[j])
        row = kt[c] == tfirst[c]
        xt[c, row] = _comb(op, np.float32(acc), xt[c, row])

    emit = tt.copy()
    if aux is not None:
        auxp = np.zeros(nt * TILE, np.float32)
        auxp[:m] = aux
        emit &= xt < auxp.reshape(nt, TILE)
    rng = np.random.default_rng(seed)
    excl = _count_lookback(emit.sum(1), rng)

    # Ranks as the kernel forms them: earlier warps, earlier rows, lower
    # lanes of the row, then the thread's own earlier lanes.
    e5 = emit.reshape(nt, WARPS, ROWS, LANES, 4).astype(np.int64)
    per_lane = e5.sum(-1)
    below = np.cumsum(per_lane, -1) - (0 if mutate == "rank" else per_lane)
    own = np.cumsum(e5, -1) - e5
    row_tot = per_lane.sum(-1)
    rows_before = np.cumsum(row_tot, -1) - row_tot
    warp_tot = row_tot.sum(-1)
    warps_before = np.cumsum(warp_tot, -1) - warp_tot
    rank = (excl[:, None, None, None, None]
            + warps_before[:, :, None, None, None]
            + rows_before[..., None, None] + below[..., None] + own)
    rank = rank.reshape(-1)
    keep = emit.reshape(-1) & (rank < out_lanes)
    ids[rank[keep]] = key[keep]
    rvals[rank[keep]] = xt.reshape(-1)[keep]
    return ids, rvals, int(excl[-1] + emit[-1].sum())


def _plain(sd, vals, aux, op, out_lanes):
    t = lambda a: None if a is None else torch.from_numpy(a)
    wid, wval, wcnt = K.reduce_by_dst_sorted_plain(
        t(sd), t(vals), op=op, out_lanes=out_lanes, aux=t(aux))
    return wid.numpy(), wval.numpy(), int(wcnt)


def _agrees(got, want, op, out_lanes) -> bool:
    (gid, gval, gcnt), (wid, wval, wcnt) = got, want
    k = min(gcnt, out_lanes)
    if gcnt != wcnt or not np.array_equal(gid[:k], wid[:k]):
        return False
    if op == "min":
        return np.array_equal(gval[:k], wval[:k])
    return np.allclose(gval[:k], wval[:k], rtol=1e-6, atol=0, equal_nan=True)


def _push_round(scale, kind, seed):
    """K7's inputs at a push round on R-MAT ``scale``: SSSP's fused min
    with ``aux = dist[sd]`` (``models/sssp.py``), BC's forward sum of the
    negated counts with ``aux = +-inf`` (``models/bc.py``
    ``_fwd_push_fused``), or BC's backward sum by source with the
    largest-degree vertex in the ring (``_bwd_push_fused``)."""
    g = gtt.io.rmat(scale=scale, edge_factor=16, seed=seed, undirected=True)
    g.random_edge_values(seed=seed)
    dg = gtt.to_device(g, with_edge_values=True, device="cpu")
    rng = np.random.default_rng(seed)
    frontier = np.sort(rng.choice(dg.num_nodes, dg.num_nodes // 2,
                                  replace=False))
    if kind == "bc_bwd":
        frontier = np.union1d(frontier, [g.largest_degree_vertex()])
    ex = expand(dg, torch.from_numpy(frontier.astype(np.int32)),
                with_dst=False)
    dst = K.sample_sorted(dg.col_indices, ex.eid)
    state = rng.random(dg.v_pad).astype(np.float32) * 20
    if kind == "bc_bwd":
        add = rng.random(ex.total).astype(np.float32)
        return ex.src.numpy(), add, None, min(ex.total, dg.v_pad) + 128
    sd, order = torch.sort(dst, stable=True)
    sd, order = sd.numpy(), order.numpy()
    if kind == "sssp":
        w = K.sample_sorted(dg.edge_values, ex.eid).numpy()
        half = np.where(rng.random(dg.v_pad) < 0.5, np.inf, state)
        cand = (half[ex.src.numpy()] + w).astype(np.float32)[order]
        return sd, cand, half[sd].astype(np.float32), dg.v_pad
    sig = np.floor(state)[ex.src.numpy()].astype(np.float32)
    new = rng.random(dg.v_pad) < 0.5
    aux = np.where(new, np.inf, -np.inf).astype(np.float32)[sd]
    return sd, -sig[order], aux, dg.v_pad


PUSH_KINDS = ["sssp", "bc_fwd", "bc_bwd"]


@pytest.mark.parametrize("kind", PUSH_KINDS)
@pytest.mark.parametrize("scale", [10, 11, 12])
def test_k7_model_on_push_rounds_equals_plain(scale, kind):
    sd, vals, aux, out_lanes = _push_round(scale, kind, seed=scale)
    op = "min" if kind == "sssp" else "sum"
    assert sd.shape[0] > TILE
    want = _plain(sd, vals, aux, op, out_lanes)
    for seed in range(2):      # two orders of the count look-back
        got = k7_model(sd, vals, aux, op=op, out_lanes=out_lanes, seed=seed)
        assert _agrees(got, want, op, out_lanes)


@pytest.mark.parametrize("op", ["min", "sum"])
@pytest.mark.parametrize("name", REDUCE_CASES)
def test_k7_model_edge_cases_equal_plain(name, op):
    sd, vals, aux, out_lanes = reduce_case(name, op)
    got = k7_model(sd, vals, aux, op=op, out_lanes=out_lanes, seed=1)
    assert _agrees(got, _plain(sd, vals, aux, op, out_lanes), op, out_lanes)
    if name == "overflow":
        assert got[2] > out_lanes
    if name == "aux_rejects_all":
        assert got[2] == 0


@pytest.mark.parametrize("mutate", MUTATIONS)
def test_k7_model_mutations_are_caught(mutate):
    """Each broken step of the model fails cases that the true model
    passes: the comparisons above see the carry and the rank."""
    failed = 0
    for name in ("span2", "span40", "aligned", "overflow"):
        for op in ("min", "sum"):
            sd, vals, aux, out_lanes = reduce_case(name, op)
            got = k7_model(sd, vals, aux, op=op, out_lanes=out_lanes,
                           mutate=mutate)
            failed += not _agrees(got, _plain(sd, vals, aux, op, out_lanes),
                                  op, out_lanes)
    assert failed >= 2


def test_reduce_tile_is_the_kernels():
    """The wrapper sizes the tile states by the tile the kernel was
    written for (``kReduceTile``, which ``gr_reduce_by_dst_sorted``
    checks), and the model's shape is the kernel's."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                            "sssp_kernels.cu")).read()
    consts = dict(re.findall(r"constexpr int (kReduce\w+) = (\d+);", src))
    assert int(consts["kReduceThreads"]) == 32 * WARPS
    assert int(consts["kReduceRows"]) == ROWS
    assert WARPS * ROWS * 128 == TILE == 2048


@pytest.mark.parametrize("kind", ["sssp", "bc_fwd"])
def test_k7_model_equals_pallas(kind):
    """The model against the Pallas ``reduce_by_dst_sorted`` in interpret
    mode, on R-MAT 10 push rounds."""
    sd, vals, aux, out_lanes = _push_round(10, kind, seed=3)
    op = "min" if kind == "sssp" else "sum"
    wid, wval, wcnt = pk.reduce_by_dst_sorted(
        jnp.asarray(sd), jnp.asarray(vals), op=op, out_lanes=out_lanes,
        aux=jnp.asarray(aux), interpret=True)
    gid, gval, gcnt = k7_model(sd, vals, aux, op=op, out_lanes=out_lanes)
    assert gcnt == int(wcnt)
    k = min(gcnt, out_lanes)
    np.testing.assert_array_equal(gid[:k], np.asarray(wid)[:k])
    if op == "min":
        np.testing.assert_array_equal(gval[:k], np.asarray(wval)[:k])
    else:
        np.testing.assert_allclose(gval[:k], np.asarray(wval)[:k], rtol=1e-5)
