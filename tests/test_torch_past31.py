"""Kernel K3 past 2^31 edges, checked on the CPU.

K3 (``ops.pull2.pull_reduce2``) reads a sizet64 graph's int64 CSC
offsets as they are, through the int64 instance of its tile prologue
(``csc_tile_rows_kernel`` in ``csrc/tiles.cuh``) and of pass 1's row
starts and the finish's row bounds (``csrc/pull_kernels.cu``). A CUDA
kernel cannot run here, so:

  * a numpy model of the prologue and of pass 1's walk of the row
    starts, statement by statement, is driven by offsets alone whose
    sums pass 2^31 (no edge is materialized) and held against a direct
    search; the same model reading the offsets as int32 (the truncation
    the int64 instance removes) must fail;
  * the wrapper's arguments are recorded with the launch stubbed
    (``dry_launch``): the int64 offsets go to the kernel unnarrowed, at
    any edge count, while K1, K4, K6 and K9 keep their int32 bounds,
    narrowed below 2^31 edges and refused past it;
  * K3's plain version on a sizet64 upload equals the int32 upload's,
    bit for bit (integer offsets; the sums are the same).

Tolerances: none; every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gunrock_tpu_torch.ops import _build
from gunrock_tpu_torch.ops import kernels as K
from gunrock_tpu_torch.ops import pull2 as P

TILE = P.PULL_TILE


def _offsets(seed: int) -> np.ndarray:
    """int64 offsets of about 600 rows summing past 2^31: heavy rows of
    up to 2^24 edges, short rows and empty runs, some heavy rows starting
    exactly on a tile boundary."""
    rng = np.random.default_rng(seed)
    deg = np.where(rng.random(600) < 0.5,
                   rng.integers(1 << 22, 1 << 24, 600),
                   rng.integers(0, 3 * TILE, 600))
    deg[rng.random(600) < 0.1] = 0
    off = np.zeros(deg.size + 1, np.int64)
    np.cumsum(deg, out=off[1:])
    # Pad a few rows so that the next one starts on a tile boundary.
    for r in rng.choice(np.arange(1, deg.size - 1), 5, replace=False):
        off[r + 1:] += (-off[r + 1]) % TILE
    assert off[-1] > 2**31
    return off


def _read(off: np.ndarray, off_type) -> np.ndarray:
    """The offsets as the kernel reads them: ``const Off*``; int32 wraps."""
    return off.astype(off_type).astype(np.int64)


def tile_rows_model(off: np.ndarray, off_type) -> np.ndarray:
    """``csc_tile_rows_kernel``: each row v with lo = offsets[v], hi =
    offsets[v + 1] writes tile_rows[t] = v for t from ceil(lo / T) while
    t * T < hi; thread 0 writes tile_rows[ntiles] = rows. ``num_edges``
    is an int64 argument. Writes out of range (a truncated read) are
    dropped."""
    rows = off.shape[0] - 1
    num_edges = int(off[-1])
    ntiles = -(-num_edges // TILE)
    o = _read(off, off_type)
    lo, hi = o[:-1], o[1:]
    t0 = -(-lo // TILE)
    t1 = -(-hi // TILE)                   # first t with t * T >= hi
    n = np.maximum(t1 - t0, 0)
    row = np.repeat(np.arange(rows), n)
    t = np.repeat(t0, n) + (np.arange(n.sum()) - np.repeat(
        np.cumsum(n) - n, n))
    out = np.full(ntiles + 1, -1, np.int64)
    ok = (t >= 0) & (t < ntiles)
    out[t[ok]] = row[ok]
    out[ntiles] = rows
    return out


def row_starts_model(off: np.ndarray, tile_rows: np.ndarray,
                     off_type) -> np.ndarray:
    """Pass 1's walk, every tile at once: tile t (lo = t * T, len edges)
    reads rows r = tile_rows[t] + 1 .. tile_rows[t + 1], r < rows, and
    marks starts[s - lo] = r where s = offsets[r] < lo + len and
    offsets[r + 1] > s. Returns the marks as (tile, position, row)
    rows."""
    rows = off.shape[0] - 1
    num_edges = int(off[-1])
    ntiles = tile_rows.shape[0] - 1
    o = _read(off, off_type)
    first = tile_rows[:-1] + 1
    last = np.minimum(tile_rows[1:], rows - 1)
    n = np.maximum(last - first + 1, 0)
    tile = np.repeat(np.arange(ntiles), n)
    r = np.repeat(first, n) + (np.arange(n.sum()) - np.repeat(
        np.cumsum(n) - n, n))
    lo = tile * TILE
    length = np.minimum(num_edges - lo, TILE)
    s = o[r]
    mark = (s < lo + length) & (o[r + 1] > s)
    return np.stack([tile[mark], s[mark] - lo[mark], r[mark]], axis=1)


def direct_tile_rows(off: np.ndarray) -> np.ndarray:
    """The row holding each tile's first edge, by binary search, then
    rows."""
    ntiles = -(-int(off[-1]) // TILE)
    first = np.arange(ntiles, dtype=np.int64) * TILE
    held = np.searchsorted(off, first, side="right") - 1
    return np.append(held, off.shape[0] - 1)


def direct_row_starts(off: np.ndarray) -> np.ndarray:
    """Every nonempty row that starts inside a tile, past its first edge
    (the row at the first edge is tile_rows[t], which thread 0 takes)."""
    r = np.nonzero(off[1:] > off[:-1])[0]
    s = off[r]
    inside = s % TILE != 0
    r, s = r[inside], s[inside]
    return np.stack([s // TILE, s % TILE, r], axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int64_prologue_and_row_starts_past_2_31(seed):
    off = _offsets(seed)
    tr = tile_rows_model(off, np.int64)
    np.testing.assert_array_equal(tr, direct_tile_rows(off))
    got = row_starts_model(off, tr, np.int64)
    np.testing.assert_array_equal(got, direct_row_starts(off))


@pytest.mark.parametrize("seed", [0, 1])
def test_int32_truncation_fails_past_2_31(seed):
    """The mutation: offsets read as int32 wrap past 2^31, and the model
    no longer finds the rows."""
    off = _offsets(seed)
    tr = tile_rows_model(off, np.int32)
    bad = not np.array_equal(tr, direct_tile_rows(off))
    if not bad:
        got = row_starts_model(off, tr, np.int32)
        bad = not np.array_equal(got, direct_row_starts(off))
    assert bad


def test_int32_reads_agree_below_2_31():
    """Below 2^31 edges both instances read the same bounds: the int32
    model equals the direct search too."""
    off = _offsets(3)
    off = off[:np.searchsorted(off, 2**31 - 1, side="right")]
    tr = tile_rows_model(off, np.int32)
    np.testing.assert_array_equal(tr, direct_tile_rows(off))
    np.testing.assert_array_equal(row_starts_model(off, tr, np.int32),
                                  direct_row_starts(off))


@pytest.fixture(scope="module")
def uploads():
    g = gtt.io.rmat(scale=10, edge_factor=8, seed=5, undirected=True)
    g.random_edge_values(seed=5)
    kw = dict(with_csc=True, with_edge_values=True, device="cpu")
    return (gtt.to_device(g, sizet64=True, **kw),
            gtt.to_device(g, sizet64=False, **kw))


MODES = {
    "sum/none": dict(op="sum", wmode="none"),
    "sum/mul val": dict(op="sum", wmode="mul"),
    "sum/mul wpr": dict(op="sum", wmode="mul", weights="wpr"),
    "min/add": dict(op="min", wmode="add"),
    "min/add init": dict(op="min", wmode="add", init=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_k3_plain_sizet64_equals_int32(uploads, mode):
    g64, g32 = uploads
    assert g64.csc_offsets.dtype == torch.int64
    assert g32.csc_offsets.dtype == torch.int32
    kw = dict(MODES[mode])
    vals = torch.from_numpy(np.random.default_rng(1).random(
        g32.v_pad).astype(np.float32))
    if kw.pop("init", False):
        kw["init"] = vals * 2.0
    got = P.pull_reduce2(vals, g64, **kw)
    want = P.pull_reduce2(vals, g32, **kw)
    assert torch.equal(got, want)
    assert torch.equal(P.pull_vertex_reduce(vals, g64, op=kw["op"],
                                            wmode=kw["wmode"]),
                       P.pull_vertex_reduce(vals, g32, op=kw["op"],
                                            wmode=kw["wmode"]))


class _Lib:
    def __getattr__(self, name):
        def stub(*args):
            raise AssertionError("called outside _launch")
        stub.__name__ = name
        return stub


@pytest.fixture
def dry_launch(monkeypatch):
    """Route CPU tensors to the kernel wrappers and record each launch
    as (entry point, arguments without the stream)."""
    calls = []

    def launch(fn, *args, device):
        calls.append((fn.__name__, args))

    for mod in (K, P):
        monkeypatch.setattr(mod, "_route", lambda *t: True)
        monkeypatch.setattr(mod, "_launch", launch)
    monkeypatch.setattr(_build, "load", lambda: _Lib())
    return calls


# gr_pull_reduce's parameters: values, indices, offsets, offsets64,
# num_edges, ...
_OFFSETS, _WIDE, _EDGES = 2, 3, 4


@pytest.mark.parametrize("edges", ["upload", "past 2^31"])
def test_k3_takes_int64_offsets_as_they_are(uploads, dry_launch, edges):
    """Step 2's rule: K3 on a sizet64 graph takes the int64 offsets
    themselves, with no narrowing and no refusal past 2^31 edges; the
    int32 upload keeps the int32 instance."""
    g64, g32 = uploads
    if edges == "past 2^31":
        g64 = dataclasses.replace(g64, num_edges=2**31 + 7)
    vals = torch.rand(g32.v_pad)
    P.pull_reduce2(vals, g64, op="sum")
    P.pull_vertex_reduce(vals, g64, op="min", wmode="add")
    P.pull_reduce2(vals, g32, op="sum")
    assert [c[0] for c in dry_launch] == ["gr_pull_reduce"] * 3
    for name, args in dry_launch[:2]:
        assert args[_OFFSETS] == g64.csc_offsets.data_ptr()
        assert args[_WIDE] == 1
        assert args[_EDGES] == g64.num_edges
    assert dry_launch[2][1][_OFFSETS] == g32.csc_offsets.data_ptr()
    assert dry_launch[2][1][_WIDE] == 0


def _blocked_call(name, g):
    f32 = torch.rand(g.v_pad)
    words = K.pack_bitmask(f32 > 0.5)
    return {
        "K1": lambda: K.pull_reached_words(words, g),
        "K4": lambda: P.pull_power_iters(g, f32, iters=2, damping=0.85,
                                         reset=0.1),
        "K6": lambda: P.pull_min_sweeps(g, f32, sweeps=2),
        "K9": lambda: P.brandes_fwd_levels(g, f32, f32, d0=1, levels=2),
    }[name]


@pytest.mark.parametrize("kernel", ["K1", "K4", "K6", "K9"])
def test_blocked_kernels_keep_int32_bounds(uploads, dry_launch, kernel):
    """K1, K4, K6 and K9 run on the blocked routes, which a sizet64 graph
    never takes: below 2^31 edges they get the narrowed int32 bounds
    (equal to the int32 upload's), past it they refuse."""
    g64, g32 = uploads
    _blocked_call(kernel, g64)()
    (_, args), = dry_launch
    assert g64.csc_offsets.data_ptr() not in args   # a narrowed copy
    big = dataclasses.replace(g64, num_edges=2**31)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        _blocked_call(kernel, big)()
    assert len(dry_launch) == 1


def test_k3_pull_rule_past_2_31(uploads):
    """The full-edge value pulls of SSSP, CC and BC go through K3 on
    graphs uploaded with_blocked_values, as in the JAX package, and on
    graphs past 2^31 edges, where neither package holds a blocked
    layout; a sizet64 graph below 2^31 edges keeps the JAX package's
    push routes."""
    g64, g32 = uploads
    assert not g64.k3_pulls and not g32.k3_pulls
    assert dataclasses.replace(g64, num_edges=2**31).k3_pulls
    assert not dataclasses.replace(g64, num_edges=2**31 - 1).k3_pulls
    assert dataclasses.replace(g32, has_blocked_values=True).k3_pulls
