"""The ctypes launch path of the port's CUDA kernels, checked on the CPU:
the C entry points in ``gunrock_tpu_torch/csrc`` take the parameters
``_build.SIGNATURES`` gives ctypes, and every wrapper hands its entry
point arguments of those kinds, in that number, and counts one launch.
A wrong count or kind would pass a pointer where an int is read, which
only a run on the card would show."""

import os
import re

import numpy as np
import pytest
import torch

import gunrock_tpu_torch as gtt
from gunrock_tpu_torch.ops import _build
from gunrock_tpu_torch.ops import kernels as K
from gunrock_tpu_torch.ops import pull2 as P

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gunrock_tpu_torch", "csrc")
_KINDS = {"void*": "p", "int64_t": "q", "int": "i", "float": "f"}


def _c_signatures() -> dict:
    """name -> parameter letters of every ``int gr_*(...)`` definition."""
    out = {}
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name)) as f:
            src = f.read()
        for fn, params in re.findall(r"\nint (gr_\w+)\(([^)]*)\)\s*\{", src):
            kinds = []
            for param in params.split(","):
                words = param.replace("const ", "").split()
                kinds.append(_KINDS["".join(words[:-1])])
            out[fn] = "".join(kinds)
    return out


def test_c_entry_points_match_ctypes_signatures():
    got = _c_signatures()
    assert got == _build.SIGNATURES
    # every entry point takes the stream last
    assert all(sig.endswith("p") for sig in got.values())


class _Lib:
    """Stands in for the loaded library: each attribute is a named stub."""

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
        assert isinstance(device, torch.device)
        calls.append((fn.__name__, args))

    for mod in (K, P):
        monkeypatch.setattr(mod, "_route", lambda *t: True)
        monkeypatch.setattr(mod, "_launch", launch)
    monkeypatch.setattr(_build, "load", lambda: _Lib())
    return calls


def _graph():
    g = gtt.io.rmat(scale=8, edge_factor=4, seed=3, undirected=True)
    g.random_edge_values(seed=3)
    return gtt.to_device(g, with_csc=True, with_edge_values=True,
                         with_edge_src=True, device="cpu")


def _wrapper_calls(name, g):
    f32 = torch.rand(g.v_pad)
    i32 = torch.arange(100, dtype=torch.int32)
    words = K.pack_bitmask(f32 > 0.5)
    return {
        "pull_reached_words": lambda: K.pull_reached_words(words, g),
        "bitmask_gather": lambda: K.bitmask_gather(words, i32),
        "bitmask_gather_cumsum": lambda: K.bitmask_gather_cumsum(words, i32),
        "pull_reduce2": lambda: P.pull_reduce2(f32, g, op="min",
                                               wmode="add", init=f32),
        "pull_reduce2_wpr": lambda: P.pull_reduce2(f32, g, wmode="mul",
                                                   weights="wpr"),
        "pull_power_iters": lambda: P.pull_power_iters(
            g, f32, iters=3, damping=0.85, reset=0.1),
        "pull_power_iters_val": lambda: P.pull_power_iters(
            g, f32, iters=2, damping=0.85, reset=0.1, weights="val"),
        "pull_min_sweeps": lambda: P.pull_min_sweeps(g, f32, sweeps=2),
        "brandes_fwd_levels": lambda: P.brandes_fwd_levels(g, f32, f32,
                                                           d0=1, levels=2),
        "brandes_bwd_levels": lambda: P.brandes_bwd_levels(
            g, f32, f32, f32, t0=3, levels=2),
        "sample_sorted": lambda: K.sample_sorted(f32, i32),
        "sample_sorted2": lambda: K.sample_sorted2(i32, i32, i32.long()),
        "reduce_by_dst_sorted": lambda: K.reduce_by_dst_sorted(
            i32, torch.rand(100), out_lanes=50),
        "scatter_sorted": lambda: K.scatter_sorted(
            f32, i32, torch.rand(100),
            count=torch.tensor(7, dtype=torch.int32)),
        "last_hit_rows": lambda: K.last_hit_rows(
            g, torch.zeros(g.v_pad, dtype=torch.int32)),
        "last_hit_rows_sssp": lambda: K.last_hit_rows(g, f32,
                                                      g.csc_edge_values),
    }[name]


# wrapper -> (entry point, LAUNCHES key)
WRAPPERS = {
    "pull_reached_words": ("gr_pull_reached_words", "pull_reached_words"),
    "bitmask_gather": ("gr_bitmask_gather", "bitmask_gather"),
    "bitmask_gather_cumsum": ("gr_bitmask_gather_cumsum",
                              "bitmask_gather_cumsum"),
    "pull_reduce2": ("gr_pull_reduce", "pull_reduce2"),
    "pull_reduce2_wpr": ("gr_pull_reduce", "pull_reduce2"),
    "pull_power_iters": ("gr_pull_power_iters", "pull_power_iters"),
    "pull_power_iters_val": ("gr_pull_power_iters", "pull_power_iters"),
    "pull_min_sweeps": ("gr_pull_min_sweeps", "pull_min_sweeps"),
    "brandes_fwd_levels": ("gr_brandes_levels", "brandes_levels"),
    "brandes_bwd_levels": ("gr_brandes_levels", "brandes_levels"),
    "sample_sorted": ("gr_sample_sorted", "sample_sorted"),
    "sample_sorted2": ("gr_sample_sorted", "sample_sorted2"),
    "reduce_by_dst_sorted": ("gr_reduce_by_dst_sorted",
                             "reduce_by_dst_sorted"),
    "scatter_sorted": ("gr_scatter_sorted", "scatter_sorted"),
    "last_hit_rows": ("gr_last_hit_rows", "last_hit_rows"),
    "last_hit_rows_sssp": ("gr_last_hit_rows", "last_hit_rows"),
}


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_wrapper_passes_its_c_signature(wrapper, dry_launch):
    entry, key = WRAPPERS[wrapper]
    before = K.LAUNCHES[key]
    _wrapper_calls(wrapper, _graph())()
    assert K.LAUNCHES[key] == before + 1
    assert [c[0] for c in dry_launch] == [entry]
    args = dry_launch[0][1]
    sig = _build.SIGNATURES[entry][:-1]          # the stream comes last
    assert len(args) == len(sig)
    for i, (kind, arg) in enumerate(zip(sig, args)):
        want = float if kind == "f" else int
        assert type(arg) is want, (i, kind, arg)


def test_pull_scratch_fits_the_tiles():
    """K3's scratch: one tile row a tile and one past the last, per-row
    totals and value table of v_pad, head and tail partials a tile, 4
    bytes a slot, back to back in one buffer; the gated passes' (K6, K9)
    add a mark a tile and two rounds' source-group bits."""
    g = _graph()
    ntiles = -(-g.num_edges // P.PULL_TILE)
    sizes = [ntiles + 1, g.v_pad, ntiles, ntiles, g.v_pad]
    for gated, extra in ((False, []), (True, [ntiles, 2 * P.GROUP_WORDS])):
        buf, ptrs = P._scratch(g, torch.device("cpu"), gated=gated)
        want = sizes + extra
        assert buf.element_size() == 4 and buf.numel() == sum(want)
        assert ptrs == [buf.data_ptr() + 4 * sum(want[:i])
                        for i in range(len(want))]
    empty = gtt.to_device(gtt.from_coo(300, np.zeros(0, np.int64),
                                       np.zeros(0, np.int64)),
                          with_csc=True, device="cpu")
    assert P._scratch(empty, torch.device("cpu"))[0].numel() == \
        1 + 2 * empty.v_pad


@pytest.mark.parametrize("m", [1, K.REDUCE_TILE - 1, K.REDUCE_TILE,
                               K.REDUCE_TILE + 1, 40 * K.REDUCE_TILE])
def test_reduce_state_fits_the_tiles(m, dry_launch):
    """K7's one scratch buffer: the tile counter and three 64-bit words a
    tile of ``REDUCE_TILE`` lanes, handed to the entry point with that
    tile size; no other scratch."""
    tiles = -(-m // K.REDUCE_TILE)
    state = K._reduce_state(m, torch.device("cpu"))
    assert state.dtype == torch.int64 and state.numel() == 1 + 3 * tiles
    sd = torch.zeros(m, dtype=torch.int32)
    K.reduce_by_dst_sorted(sd, torch.zeros(m), out_lanes=8)
    # sd, vals, aux, m, op, tile, out_lanes, state, ids, rvals, count
    args = dry_launch[0][1]
    assert len(args) == 11
    assert args[3] == m and args[5] == K.REDUCE_TILE


@pytest.mark.parametrize("n", [1, K.GATHER_CUMSUM_TILE - 1,
                               K.GATHER_CUMSUM_TILE,
                               K.GATHER_CUMSUM_TILE + 1,
                               40 * K.GATHER_CUMSUM_TILE])
def test_gather_cumsum_state_fits_the_tiles(n, dry_launch):
    """K10's one scratch buffer: the tile counter and a 64-bit state a
    tile of ``GATHER_CUMSUM_TILE`` ids; the mask in shared memory by the
    size rule (a mask of 2^20 bits), through L1 above it (2^21)."""
    idx = torch.zeros(n, dtype=torch.int32)
    for bits, shared in ((1 << 20, 1), (1 << 21, 0)):
        words = torch.zeros(bits // 32, dtype=torch.int32)
        K.bitmask_gather_cumsum(words, idx)
        # words, nbits, idx, n, state, state words, shared, out
        args = dry_launch[-1][1]
        assert args[1] == bits and args[3] == n
        assert args[5] == 1 + -(-n // K.GATHER_CUMSUM_TILE)
        assert args[6] == shared


def test_reach_scratch_fits_the_tiles(dry_launch):
    """K1's scratch: a tile row a warp tile of ``WARP_TILE`` edges and one
    past the last; csc_offsets and v_pad rows, not csc_edge_dst."""
    g = _graph()
    words = K.pack_bitmask(torch.ones(g.v_pad, dtype=torch.bool))
    K.pull_reached_words(words, g)
    # words, nbits, indices, offsets, rows, edges, tile rows, their count,
    # out
    args = dry_launch[-1][1]
    assert args[1] == 32 * words.shape[0]
    assert args[3] == g.csc_offsets.data_ptr()
    assert args[4] == g.v_pad and args[5] == g.num_edges
    assert args[7] == -(-g.num_edges // K.WARP_TILE) + 1
    assert g.csc_edge_dst.data_ptr() not in args


@pytest.mark.parametrize("sizet64", [False, True])
def test_last_hit_args(sizet64, dry_launch):
    """K14's arguments: the CSC's offsets with their width, its indices,
    the values, the weights (none for BFS's test), v_pad rows and the
    edge count, and an int64 output of v_pad; not csc_edge_dst."""
    g = gtt.to_device(gtt.io.rmat(scale=8, edge_factor=4, seed=3),
                      with_csc=True, with_edge_values=True, sizet64=sizet64,
                      device="cpu")
    labels = torch.zeros(g.v_pad, dtype=torch.int32)
    dist = torch.zeros(g.v_pad)
    for vals, w in ((labels, None), (dist, g.csc_edge_values)):
        out = K.last_hit_rows(g, vals, w)
        # offsets, offsets64, indices, vals, weights, rows, edges, out
        args = dry_launch[-1][1]
        assert args == (g.csc_offsets.data_ptr(), int(sizet64),
                        g.csc_indices.data_ptr(), vals.data_ptr(),
                        0 if w is None else w.data_ptr(), g.v_pad,
                        g.num_edges, out.data_ptr())
        assert out.shape == (g.v_pad,) and out.dtype == torch.int64
        assert g.csc_edge_dst.data_ptr() not in args


# The profile tool's groups at a tiny size: each group's case names (the
# pull group's are checked line by line below) and its line count, the
# graph headers included.
PROFILE_GROUPS = {
    "value": (("pagerank power route", "pagerank loop route", "hits",
               "wtf"), 5),
    "sssp": (("sssp sweep route", "sssp near-far", "sssp near-far fused",
              "sssp grid", "sssp grid, deep_carry", "non-DO bfs grid",
              "DO-bfs, K10", "DO-bfs, K1", "DO-bfs grid", "bc hybrid",
              "bc hybrid fused"), 13),
    "pull": ((), 23),
    "sharded": (("DO-BFS (K1)", "non-DO BFS", "SSSP near-far (K3)"), 5),
    "tc": ((), 3),
}


@pytest.mark.parametrize("group", sorted(PROFILE_GROUPS))
def test_card_profile_group_runs_on_cpu(group, capsys):
    """One group of ``tools/card_profile.py`` at a tiny size: its cases
    run and print, no other group's; on the CPU the profiler records no
    device events, and the tool says so."""
    from gunrock_tpu_torch.tools import card_profile
    assert card_profile.main(["--scale=8", "--edge-factor=4",
                              "--grid-side=16", "--runs=1", "--reps=2",
                              "--winners=50", "--device=cpu", "--only",
                              group]) == 0
    lines = capsys.readouterr().out.splitlines()
    names, count = PROFILE_GROUPS[group]
    assert len(lines) == count and "|E|=" in lines[0]
    assert "device not measured" in "\n".join(lines)
    for name in names:
        assert any(line.startswith((f"[{name}] ", f"{name}: "))
                   for line in lines), name
    if group == "sharded":
        assert sum("median" in line and "digest" in line
                   for line in lines) == 3
    if group == "tc":
        assert lines[1].startswith("[tc] the first 1 of 1 chunks by step")
        assert lines[2].startswith("[tc] a whole run: wall")
    if group != "pull":
        return
    for line in lines[1:]:
        assert "(host " in line and "device not measured" in line, line
    assert "K3 pull_reduce2" in lines[1] and "index_reduce_" in lines[5]
    assert all("K4 pull_power_iters" in line for line in lines[6:8])
    assert "threshold 1e-6" in lines[7] and "PageRank power" in lines[8]
    assert all("K6 pull_min_sweeps" in line for line in lines[9:12])
    assert "K9" in lines[12]
    assert "K5 sample_sorted2 + sample_sorted" in lines[13]
    assert "K7 reduce_by_dst_sorted min" in lines[14]
    assert "K7 reduce_by_dst_sorted sum" in lines[15]
    assert lines[16].startswith("[profile_pull] K1 pull_reached_words, pull")
    assert "every source vertex 0" in lines[17]
    assert "K10 bitmask_gather_cumsum" in lines[18]
    assert "K10L1" in lines[19]
    assert "K2 bitmask_gather, the hub's" in lines[20]
    assert "L2 flushed" in lines[21]
    assert "K2 bitmask_gather, 4194304 random ids" in lines[22]


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_gather_output_offset(offset, dry_launch):
    """K2's arguments, and its output placed at the ids' offset mod 16
    bytes for a view at any 4-byte offset, at lengths around the quads
    and over masks on both sides of K10's shared-memory cap (K2 reads
    every mask through L1)."""
    for nwords, n in ((1024, 1), (1024, 9215), (K.SHARED_MASK_WORDS + 1,
                                                 100_003)):
        words = torch.zeros(nwords, dtype=torch.int32)
        base = torch.zeros(n + 4, dtype=torch.int32)
        idx = base[offset:offset + n]
        out = K.bitmask_gather(words, idx)
        # words, nbits, idx, n, out
        args = dry_launch[-1][1]
        assert args == (words.data_ptr(), 32 * nwords, idx.data_ptr(), n,
                        out.data_ptr())
        assert out.shape == (n,) and out.dtype == torch.int32
        assert out.data_ptr() % 16 == idx.data_ptr() % 16 == 4 * offset
