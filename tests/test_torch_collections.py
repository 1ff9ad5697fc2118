"""The `Col` basics of the PyTorch port against the JAX reference.

from_numpy lays keys, values and the mask out exactly as the reference
(round robin, KEY_PAD padding); count, map, map_values, filter and
to_numpy give the same elements in the same order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Col as RefCol  # noqa: E402
from repro_torch.core import Col, Graph  # noqa: E402
from repro_torch.core.collections import KEY_PAD  # noqa: E402
from repro_torch.data import rmat  # noqa: E402


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40, n).astype(np.int32)
    vals = {"x": rng.normal(size=n).astype(np.float32),
            "y": rng.integers(-50, 50, (n, 3)).astype(np.int32)}
    return keys, vals


def _pair(n, seed, p=4, pad=8):
    keys, vals = _inputs(n, seed)
    return (Col.from_numpy(keys, vals, p, pad_multiple=pad, device="cpu"),
            RefCol.from_numpy(keys, vals, p, pad_multiple=pad))


def _same(col, rcol):
    np.testing.assert_array_equal(col.keys.numpy(), np.asarray(rcol.keys))
    np.testing.assert_array_equal(col.mask.numpy(), np.asarray(rcol.mask))
    for k in ("x", "y"):
        np.testing.assert_array_equal(col.values[k].numpy(),
                                      np.asarray(rcol.values[k]))


@pytest.mark.parametrize("n,p,pad", [(1, 4, 8), (37, 4, 8), (64, 3, 4),
                                     (100, 1, 8)])
def test_from_numpy_layout_equals_reference(n, p, pad):
    col, rcol = _pair(n, n, p, pad)
    _same(col, rcol)
    assert col.p == rcol.p == p
    assert int(col.count()) == int(rcol.count()) == n
    assert int((col.keys == KEY_PAD).sum()) == col.keys.numel() - n


def test_map_filter_to_numpy_equal_reference():
    col, rcol = _pair(53, 3)
    got = col.map_values(lambda v: {"x": v["x"] * 2, "y": v["y"] - 1}) \
        .filter(lambda k, v: (v["x"] >= 0) & (k % 3 != 0))
    want = rcol.map_values(lambda v: {"x": v["x"] * 2, "y": v["y"] - 1}) \
        .filter(lambda k, v: (v["x"] >= 0) & (k % 3 != 0))
    _same(got, want)
    assert int(got.count()) == int(want.count())
    k, v = got.to_numpy()
    rk, rv = want.to_numpy()
    np.testing.assert_array_equal(k, np.asarray(rk))
    for name in ("x", "y"):
        np.testing.assert_array_equal(v[name], np.asarray(rv[name]))
    mk = col.map(lambda k, v: (k + 1, {"x": v["x"] + 1.5, "y": v["y"] * k}))
    rmk = rcol.map(lambda k, v: (k + 1, {"x": v["x"] + 1.5,
                                         "y": v["y"] * k}))
    _same(mk, rmk)


def test_vertices_is_a_collection_of_the_visible_vertices():
    gd = rmat(7, 4, seed=3)
    vids = np.arange(gd.num_vertices, dtype=np.int64)
    g = Graph.from_edges(gd.src, gd.dst, vertex_keys=vids,
                         vertex_values={"age": (20 + vids % 50).astype(
                             np.float32)},
                         default_vertex={"age": np.float32(0)},
                         num_partitions=4, device="cpu")
    verts = g.vertices()
    assert isinstance(verts, Col)
    n40 = verts.filter(lambda k, v: v["age"] > 40).count()
    assert int(n40) == int(((20 + vids % 50) > 40).sum())
    sub = g.subgraph(vpred=lambda vid, v: v["age"] <= 40)
    assert int(sub.vertices().count()) == int(((20 + vids % 50) <= 40).sum())
