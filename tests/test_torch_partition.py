"""Structure build of the PyTorch port against the JAX reference.

Every GraphStructure field except the Pallas `tiles` must be byte-identical
to the reference's, for every partitioner, with and without a broadcast
set.  The GPU tables that replace `tiles` are checked for meaning: each
live edge sits once in its slot's CSR range, in edge order, and every
live route entry lies in its home slot's granule range of apply_rng.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import hashing as ref_hashing  # noqa: E402
from repro.core import partition as ref_part  # noqa: E402
from repro.data import graphs as ref_graphs  # noqa: E402
from repro_torch.core import hashing, partition  # noqa: E402
from repro_torch.kernels import applyroute  # noqa: E402
from repro_torch.data import graphs  # noqa: E402


def _graph(kind):
    gd = graphs.rmat(10, 8, seed=42)
    return graphs.symmetrize(gd) if kind == "sym" else gd


def _equal(a, b, where):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, tuple):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("kind", ["rmat", "sym"])
@pytest.mark.parametrize("bcast", [None, 2])
@pytest.mark.parametrize("partitioner", ["2d", "1d", "random", "hybrid"])
def test_structure_matches_reference(kind, bcast, partitioner):
    gd = _graph(kind)
    want = ref_part.build_structure(gd.src, gd.dst, 4, partitioner=partitioner,
                                    bcast_min_repl=bcast)
    got = partition.build_structure(gd.src, gd.dst, 4, partitioner=partitioner,
                                    bcast_min_repl=bcast)
    for f in dataclasses.fields(want):
        if f.name in ("tiles", "stats"):
            continue
        _equal(getattr(want, f.name), getattr(got, f.name), f.name)
    assert dataclasses.astuple(want.stats)[:7] == dataclasses.astuple(got.stats)[:7]
    _equal(want.stats.vertex_ids, got.stats.vertex_ids, "vertex_ids")
    _equal(want.stats.replication, got.stats.replication, "replication")
    assert got.stats.replication_factor == want.stats.replication_factor
    vids = want.stats.vertex_ids[::7]
    _equal(want.stats.replication_of(vids), got.stats.replication_of(vids),
           "replication_of")
    assert (got.brecv is not None) == (got.stats.n_broadcast > 0)


@pytest.mark.parametrize("kind", ["rmat", "sym"])
def test_gpu_tables_meaning(kind):
    gd = _graph(kind)
    s = partition.build_structure(gd.src, gd.dst, 4)
    for q in range(s.num_partitions):
        n = int(s.edge_mask[q].sum())
        for side, slots, order in (
                ("dst", s.dst_slot[q], np.arange(s.e_blk)),
                ("src", s.src_slot[q], s.src_perm[q])):
            ptr = s.agg_ptr[side][q]
            assert ptr[0] == 0 and ptr[-1] == n and np.all(np.diff(ptr) >= 0)
            seen = []
            for v in range(s.v_mir):
                edges = order[ptr[v]:ptr[v + 1]]
                assert np.all(slots[edges] == v)
                assert np.all(np.diff(edges) > 0)      # ascending edge rows
                seen.extend(edges.tolist())
            # every live edge exactly once, in the CSR walk's order
            assert sorted(seen) == list(range(n))
            if side == "src":
                assert seen == s.src_perm[q][:n].tolist()
    for side in ("dst", "src"):
        send = s.routes[side][0]
        rng = s.apply_rng[side]
        q, pe, j = np.nonzero(send >= 0)
        # each live route entry lies in its home slot's granule range
        b = send[q, pe, j] // applyroute.APPLY_GRAN
        assert np.all((rng[q, pe, b] <= j) & (j < rng[q, pe, b + 1]))
        assert np.array_equal(rng[:, :, -1], (send >= 0).sum(axis=2))


def test_gpu_tables_need_live_prefix():
    gd = _graph("rmat")
    s = partition.build_structure(gd.src, gd.dst, 4)
    mask = s.edge_mask.copy()
    mask[0, 0] = False
    with pytest.raises(ValueError):
        partition.gpu_tables(s.src_slot, s.dst_slot, s.src_perm, mask,
                             s.routes, s.v_mir, s.v_blk)


@pytest.mark.parametrize("salt", [0, 0x5EED, 0xF00D])
def test_hashing_matches_reference(salt):
    x = np.random.default_rng(7).integers(0, 2**31 - 1, 4096)
    assert np.array_equal(hashing.hash_mod(x, 7, salt=salt),
                          ref_hashing.hash_mod(x, 7, salt=salt))
    assert np.array_equal(hashing.hash_mod32(x, 4, salt=salt),
                          ref_hashing.hash_mod32(x, 4, salt=salt))


@pytest.mark.parametrize("make", [
    lambda m: m.rmat(9, 4, seed=3), lambda m: m.symmetrize(m.rmat(8, 4, seed=1)),
    lambda m: m.chain(50), lambda m: m.star(40),
    lambda m: m.table1("livejournal-sim")])
def test_generators_match_reference(make):
    a, b = make(graphs), make(ref_graphs)
    assert a.num_vertices == b.num_vertices
    assert np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)
