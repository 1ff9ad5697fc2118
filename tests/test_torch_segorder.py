"""The summation order the port's triplet and segment_sum kernels share.

`csrc/segorder.cuh` states it; `kernels/segorder.py` builds its piece
tables and `kernels/ref.py:ordered_segment_reduce` models it in plain
PyTorch.  On the CPU these tests hold the tables to their meaning, the
Python constant to the header's, the model to the plain versions (bit for
bit where every segment is one piece, within chip_smoke's f32 bound on a
hub graph), and the build key to the header's text.  The kernels themselves
are held to the model on the card (tests/test_torch_cuda.py).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import Graph, partition  # noqa: E402
from repro_torch.core import mrtriplets as mt  # noqa: E402
from repro_torch.data import rmat, star, symmetrize  # noqa: E402
from repro_torch.data.graphs import GraphData  # noqa: E402
from repro_torch.kernels import build, ref, segorder  # noqa: E402
from repro_torch.kernels import spmv as spmv_mod  # noqa: E402

P = 4
T = segorder.SEG_PIECE


def _hub():
    """rmat(10, 8) joined to a symmetrized star whose centre (vertex 0) has
    2048 edges each way: after the 2D cut its slots hold >= 8 * T edges."""
    gd, st = rmat(10, 8, seed=42), symmetrize(star(2049))
    return GraphData(np.concatenate([gd.src, st.src]),
                     np.concatenate([gd.dst, st.dst]), 2049)


GRAPHS = {"short": lambda: rmat(7, 2, seed=1),
          "rmat": lambda: rmat(10, 8, seed=42),
          "hub": _hub}


def _graph(name):
    gd = GRAPHS[name]()
    return Graph.from_edges(gd.src, gd.dst, num_partitions=P, device="cpu")


def _covers_in_order(ptr, pieces):
    """Every CSR position of every segment in exactly one piece, pieces in
    ascending order within and across segments, none longer than T."""
    q, v, begin, end = segorder.spans(ptr, pieces)
    assert np.all(end - begin <= T) and np.all(end >= begin)
    nl, nv = ptr.shape[0], ptr.shape[1] - 1
    for p in range(nl):
        sel = q == p
        assert np.array_equal(v[sel], np.sort(v[sel], kind="stable"))
        # consecutive pieces tile [0, ptr[p, -1]) with no gap or overlap
        assert begin[sel][0] == 0 and end[sel][-1] == ptr[p, -1]
        assert np.array_equal(begin[sel][1:], end[sel][:-1])
        assert np.array_equal(np.unique(v[sel]), np.arange(nv))
        # a segment is cut at ptr[v] + k * T
        k = np.arange(sel.sum()) - pieces.ptr[p][v[sel]]
        assert np.array_equal(begin[sel], ptr[p][v[sel]] + k * T)
    n = np.diff(pieces.ptr.astype(np.int64), axis=1).reshape(-1)
    assert np.array_equal(pieces.multi, np.flatnonzero(n > 1))
    assert pieces.seg.shape[1] % segorder.WARP == 0


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_piece_tables_cover_each_position_once_in_order(name):
    gd = GRAPHS[name]()
    s = partition.build_structure(gd.src, gd.dst, P)
    for side in ("dst", "src"):
        _covers_in_order(s.agg_ptr[side], s.agg_pieces[side])
        assert all(np.array_equal(a, b) for a, b in zip(
            s.agg_pieces[side], segorder.piece_tables(s.agg_ptr[side])))
    if name == "hub":
        assert any(s.agg_pieces[side].multi.size for side in ("dst", "src"))


def test_spmv_tiles_carry_piece_tables():
    rng = np.random.default_rng(4)
    v, e = 300, 4000
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    dst[:1500] = 5
    tiles = spmv_mod.build_tiles(src, dst, rng.random(e) > 0.1, v)
    pieces = segorder.Pieces(tiles["piece_ptr"], tiles["piece_seg"],
                             tiles["piece_multi"])
    _covers_in_order(tiles["ptr"][None], pieces)
    assert pieces.multi.tolist() == [5]


def test_pieces_do_not_depend_on_the_live_mask():
    """The cut reads ptr alone (the table builder takes no mask): under two
    skipStale-like masks the graph's tables stay those of ptr, and the
    model skips the dead terms inside them (NaN there never reaches a sum)
    and counts the live ones."""
    s = _graph("hub").s
    ptr = s.agg_ptr["dst"]
    tables = segorder.piece_tables(ptr.numpy())
    rng = np.random.default_rng(0)
    for frac in (0.3, 0.9):
        live = s.edge_mask & torch.from_numpy(rng.random((P, s.e_blk)) < frac)
        msgs = torch.where(live, torch.from_numpy(
            rng.normal(size=(P, s.e_blk)).astype(np.float32)), float("nan"))
        out, cnt = ref.ordered_segment_reduce(msgs[..., None], live, ptr,
                                              tables)
        assert bool(torch.isfinite(out).all())
        ids = ref.csr_segments(live, ptr).reshape(-1)
        assert torch.equal(cnt, torch.bincount(ids, minlength=P * s.v_mir
                                               + 1)[:-1])
        assert all(np.array_equal(a, b.numpy())
                   for a, b in zip(tables, s.agg_pieces["dst"]))


def test_seg_piece_matches_the_header():
    text = (build.CSRC / "segorder.cuh").read_text()
    (value,) = re.findall(r"^#define SEG_PIECE (\d+)$", text, re.M)
    assert int(value) == segorder.SEG_PIECE


@pytest.mark.parametrize("side", ["dst", "src"])
@pytest.mark.parametrize("d", [1, 3])
def test_ordered_model_is_the_sequential_sum_on_short_segments(d, side):
    """Every segment one piece: the model is index_add_'s sequential CPU
    sum (the plain version) bit for bit, counts included."""
    s = _graph("short").s
    ptr = s.agg_ptr[side]
    assert int(torch.diff(ptr, dim=1).max()) <= T
    rng = np.random.default_rng(d)
    msgs = torch.from_numpy(rng.normal(size=(P, s.e_blk, d))
                            .astype(np.float32))
    live = s.edge_mask & torch.from_numpy(rng.random((P, s.e_blk)) < 0.7)
    out, cnt = ref.ordered_segment_reduce(msgs, live, ptr, s.agg_pieces[side])
    assert torch.equal(out, ref.segment_sum(msgs, live, ptr).reshape(-1, d))
    ids = ref.csr_segments(live, ptr).reshape(-1)
    assert torch.equal(cnt, torch.bincount(ids, minlength=P * s.v_mir + 1)
                       [:-1])


@pytest.mark.parametrize("side", ["dst", "src"])
def test_ordered_model_within_sum_tol_on_a_hub(side):
    """Slots of >= 8 pieces: another order than the plain version's, so
    within the f32 bound chip_smoke holds the kernels to (and not equal
    everywhere, or the hub would not be cut)."""
    s = _graph("hub").s
    ptr = s.agg_ptr[side]
    assert int(torch.diff(ptr, dim=1).max()) >= 8 * T
    rng = np.random.default_rng(3)
    msgs = torch.from_numpy(rng.random((P, s.e_blk, 1)).astype(np.float32))
    live = s.edge_mask & torch.from_numpy(rng.random((P, s.e_blk)) < 0.9)
    out, _ = ref.ordered_segment_reduce(msgs, live, ptr, s.agg_pieces[side])
    plain = ref.segment_sum(msgs, live, ptr).reshape(-1, 1)
    ids = ref.csr_segments(live, ptr).reshape(-1)
    keep = ids < P * s.v_mir
    limit = ref.sum_tol(ids[keep], msgs.reshape(-1, 1)[keep], P * s.v_mir)
    assert bool(((out.double() - plain.double()).abs() <= limit).all())
    long = (torch.diff(ptr, dim=1) > T).reshape(-1)
    assert torch.equal(out[~long], plain[~long])
    assert not torch.equal(out[long], plain[long])


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_ordered_model_exact_for_min_max_and_counts(reduce):
    s = _graph("hub").s
    rng = np.random.default_rng(5)
    msgs = torch.from_numpy(rng.normal(size=(P, s.e_blk, 2))
                            .astype(np.float32))
    live = s.edge_mask & torch.from_numpy(rng.random((P, s.e_blk)) < 0.6)
    out, cnt = ref.ordered_segment_reduce(msgs, live, s.agg_ptr["dst"],
                                          s.agg_pieces["dst"], reduce)
    ids = ref.csr_segments(live, s.agg_ptr["dst"]).reshape(-1)
    n = P * s.v_mir
    want = torch.full((n + 1, 2), ref.REDUCE_IDENTITY[reduce])
    want.scatter_reduce_(0, ids[:, None].expand(-1, 2), msgs.reshape(-1, 2),
                         {"min": "amin", "max": "amax"}[reduce])
    assert torch.equal(out, want[:n])
    assert torch.equal(cnt, torch.bincount(ids, minlength=n + 1)[:n])


def _pr_like(sv, ev, dv):
    return {"m": sv["a"] * ev["w"]}


@pytest.mark.parametrize("to", ["dst", "src"])
def test_ordered_triplet_equals_ordered_segment_sum_on_the_same_messages(to):
    """The fused model (UDF at CSR positions through triplet_messages) and
    the unfused one (messages made in stored edge order, permuted to the
    aggregation side's CSR order, then summed) agree bit for bit."""
    g = _graph("hub")
    s = g.s
    rng = np.random.default_rng(6)
    a = rng.normal(size=tuple(s.home_vid.shape)).astype(np.float32)
    g = g.replace(vdata={"a": torch.from_numpy(a)})
    spec = mt.fused_plan(g, _pr_like, "sum").kernel
    x = torch.from_numpy(rng.normal(size=(P * s.v_mir, 1)).astype(np.float32))
    ev = torch.from_numpy(rng.normal(size=(P * s.e_blk, 1))
                          .astype(np.float32))
    live = s.edge_mask & torch.from_numpy(rng.random((P, s.e_blk)) < 0.8)
    perm = s.src_perm if to == "src" else None
    fused, cnt = ref.ordered_triplet(x, ev, s.src_slot, s.dst_slot, live,
                                     s.agg_ptr[to], perm, spec,
                                     s.agg_pieces[to])
    off = torch.arange(P)[:, None] * s.v_mir
    msgs = (x[(s.src_slot + off).reshape(-1).long()]
            * ev).reshape(P, s.e_blk, 1)
    lv = live
    if to == "src":
        order = s.src_perm.long()
        msgs = torch.gather(msgs, 1, order[..., None])
        lv = torch.gather(live, 1, order)
    unfused, ucnt = ref.ordered_segment_reduce(msgs, lv, s.agg_ptr[to],
                                               s.agg_pieces[to])
    assert torch.equal(fused, unfused)
    assert torch.equal(cnt, ucnt.float())


def test_template_hash_covers_the_header(tmp_path, monkeypatch):
    """build.template inlines csrc/segorder.cuh, so an edit of the header
    alone changes the build key `build.load` uses."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_text(f.read_text())
    before = {n: build.template(n) for n in ("triplet", "segment_sum")}
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert {n: build.template(n) for n in before} == before
    assert all('#include "segorder.cuh"' not in t for t in before.values())
    hdr = tmp_path / "segorder.cuh"
    hdr.write_text(hdr.read_text().replace("#define SEG_PIECE",
                                           "// edited\n#define SEG_PIECE"))
    for n, text in before.items():
        after = build.template(n)
        assert "// edited" in after
        assert build._target(n, after) != build._target(n, text)
