"""The `Col` operators of the PyTorch port against the JAX reference.

from_numpy lays keys, values and the mask out exactly as the reference
(round robin, KEY_PAD padding); count, map, map_values, filter and
to_numpy give the same elements in the same order.  The shuffling
operators (shuffle_by_key, reduce_by_key, left_join, compact) give the
reference's whole output arrays byte for byte (keys, every value leaf,
mask, padding slots included, and the overflow / dropped counts), f32
sums included: the mirrors of tests/test_collections.py, hypothesis cases
and all, also hold their plain-python oracles.  The tensor hash equals
hash_mod_jnp and hash_mod32 on int32 extremes, KEY_PAD and salts for P
1-8, and the segmented scan equals the reference's associative scan bit
for bit (sum, min, max, mul, a callable) at lengths 1, 2, odd, even and
4097.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import Col as RefCol  # noqa: E402
from repro.core import shuffle_by_key as ref_shuffle  # noqa: E402
from repro.core.collections import (  # noqa: E402
    _seg_reduce_sorted as ref_seg_reduce)
from repro.core.hashing import hash_mod32, hash_mod_jnp  # noqa: E402
from repro_torch.core import Col, Graph, shuffle_by_key  # noqa: E402
from repro_torch.core.collections import (  # noqa: E402
    KEY_PAD, _seg_reduce_sorted)
from repro_torch.core.hashing import hash_mod_t  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data import rmat  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # dev-only dependency (requirements-dev.txt)
    HAVE_HYPOTHESIS = False


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


# ------------------------------------------------- the shuffling operators
def _bytes_equal(got, want):
    """Two pytrees of arrays (port tensors, reference arrays) equal leaf
    for leaf in structure, dtype, shape and bytes."""
    a, b = tree_leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype)
        assert x.tobytes() == y.tobytes()


def _col_equal(col, rcol, extra=(), rextra=()):
    _bytes_equal((col.keys, col.values, col.mask, *extra),
                 (rcol.keys, rcol.values, rcol.mask, *rextra))


def _make(pairs, p=4):
    ks = np.array([k for k, _ in pairs], np.int32)
    vs = {"x": np.array([v for _, v in pairs], np.float32)}
    return (Col.from_numpy(ks, vs, p=p, device="cpu"),
            RefCol.from_numpy(ks, vs, p=p))


def _dict_of(col, leaf="x"):
    k, v = col.to_numpy()
    return dict(zip(k.tolist(), v[leaf].tolist()))


def _check_roundtrip(pairs):
    col, rcol = _make(pairs)
    _col_equal(col, rcol)
    assert int(col.count()) == int(rcol.count()) == len(pairs)
    k, _ = col.to_numpy()
    assert sorted(k.tolist()) == sorted(kk for kk, _ in pairs)


def _check_reduce(pairs, op):
    col, rcol = _make(pairs)
    red, ovf = col.reduce_by_key(op)
    rred, rovf = rcol.reduce_by_key(op)
    _col_equal(red, rred, (ovf,), (rovf,))
    assert int(ovf) == 0
    fn = {"sum": lambda a, b: a + b, "min": min, "max": max}[op]
    want: dict = {}
    for kk, vv in pairs:
        want[kk] = fn(want[kk], vv) if kk in want else vv
    got = _dict_of(red)
    assert set(got) == set(want)
    for kk in want:       # small integers: f32 sums are exact
        assert got[kk] == want[kk]


def _check_map_filter(pairs):
    col, rcol = _make(pairs)
    kept = col.map_values(lambda v: {"x": v["x"] * 2}).filter(
        lambda k, v: v["x"] >= 0)
    rkept = rcol.map_values(lambda v: {"x": v["x"] * 2}).filter(
        lambda k, v: v["x"] >= 0)
    _col_equal(kept, rkept)
    k, v = kept.to_numpy()
    want = [(kk, float(vv * 2)) for kk, vv in pairs if vv * 2 >= 0]
    assert sorted(zip(k.tolist(), v["x"].tolist())) == sorted(want)


def _check_left_join(left, right):
    rdict = dict(right) or {0: 0}     # the right side is unique-keyed
    rcol, rrcol = _make(list(rdict.items()))
    lcol, rlcol = _make(left)
    joined, ovf = lcol.left_join(rcol)
    rjoined, rovf = rlcol.left_join(rrcol)
    _col_equal(joined, rjoined, (ovf,), (rovf,))
    assert int(ovf) == 0
    k, (vl, vr, hit) = joined.to_numpy()
    for kk, rv, h in zip(k.tolist(), vr["x"].tolist(), hit.tolist()):
        assert h == (kk in rdict)
        if h:
            assert rv == rdict[kk]


_KV_CASES = [[(3, 7)], [(1, 2), (1, 3), (2, 5)],
             [(k % 21, (k * 37) % 201 - 100) for k in range(60)],
             [(0, -100), (20, 100)] * 13]


@pytest.mark.parametrize("pairs", _KV_CASES)
def test_count_and_roundtrip_equal_reference(pairs):
    _check_roundtrip(pairs)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("pairs", _KV_CASES)
def test_reduce_by_key_equals_reference_and_dict(pairs, op):
    _check_reduce(pairs, op)


@pytest.mark.parametrize("pairs", _KV_CASES)
def test_map_filter_local_equals_reference(pairs):
    _check_map_filter(pairs)


@pytest.mark.parametrize("left,right", [(_KV_CASES[2], _KV_CASES[1]),
                                        (_KV_CASES[1], _KV_CASES[2]),
                                        (_KV_CASES[3], [])])
def test_left_join_equals_reference_and_dict(left, right):
    _check_left_join(left, right)


if HAVE_HYPOTHESIS:
    def kv_strategy(max_n=60):
        return st.lists(st.tuples(st.integers(0, 20), st.integers(-100, 100)),
                        min_size=1, max_size=max_n)

    @settings(max_examples=40, deadline=None)
    @given(kv_strategy())
    def test_hypothesis_count_and_roundtrip(pairs):
        _check_roundtrip(pairs)

    @settings(max_examples=40, deadline=None)
    @given(kv_strategy(), st.sampled_from(["sum", "min", "max"]))
    def test_hypothesis_reduce_by_key_matches_dict(pairs, op):
        _check_reduce(pairs, op)

    @settings(max_examples=30, deadline=None)
    @given(kv_strategy())
    def test_hypothesis_map_filter_local(pairs):
        _check_map_filter(pairs)

    @settings(max_examples=25, deadline=None)
    @given(kv_strategy(max_n=30), kv_strategy(max_n=30))
    def test_hypothesis_left_join_matches_dict(left, right):
        _check_left_join(left, right)


def test_generic_reduce_fn_equals_reference():
    col, rcol = _make([(1, 2), (1, 3), (2, 5)])
    red, ovf = col.reduce_by_key(lambda a, b: a * b)    # a custom monoid
    rred, rovf = rcol.reduce_by_key(lambda a, b: a * b)
    _col_equal(red, rred, (ovf,), (rovf,))
    got = _dict_of(red)
    assert got[1] == 6.0 and got[2] == 5.0


def test_overflow_reported_as_the_reference():
    col, rcol = _make([(7, i) for i in range(40)])      # all to one home
    red, ovf = col.reduce_by_key("sum", capacity=4)
    rred, rovf = rcol.reduce_by_key("sum", capacity=4)
    _col_equal(red, rred, (ovf,), (rovf,))
    assert int(ovf) > 0 and ovf.device.type == "cpu"


def test_compact_preserves_content_as_the_reference():
    keys = np.arange(40, dtype=np.int32)
    vals = {"v": (keys * 2).astype(np.float32)}
    col = Col.from_numpy(keys, vals, p=4, device="cpu")
    rcol = RefCol.from_numpy(keys, vals, p=4)
    red, ovf = col.reduce_by_key("sum")                 # wide output
    rred, _ = rcol.reduce_by_key("sum")
    assert int(ovf) == 0
    for width in (16, 1):     # an over-tight width reports its drops
        narrow, dropped = red.compact(width)
        rnarrow, rdropped = rred.compact(width)
        _col_equal(narrow, rnarrow, (dropped,), (rdropped,))
        assert (int(dropped) > 0) == (width == 1)
    narrow, _ = red.compact(16)
    assert sorted(_dict_of(red, "v").items()) == \
        sorted(_dict_of(narrow, "v").items())


@pytest.mark.parametrize("p,capacity,salt", [(4, 8, 0), (3, 2, 7), (1, 64, 0),
                                             (8, 3, 0x5EED)])
def test_shuffle_by_key_equals_reference(p, capacity, salt):
    keys, vals = _inputs(101, p)
    vals = {"x": vals["x"], "z": vals["y"][:, 0]}
    keys[::7] = KEY_PAD - 1
    col = Col.from_numpy(keys, vals, p, device="cpu")
    rcol = RefCol.from_numpy(keys, vals, p)
    got = shuffle_by_key(col.keys, col.values, col.mask, col.ex, capacity,
                         salt)
    want = ref_shuffle(rcol.keys, rcol.values, rcol.mask, rcol.ex, capacity,
                       salt)
    _bytes_equal(got, want)


def test_f32_sums_on_a_hub_key_equal_reference():
    """One key holding most entries: the scan's combine order decides
    every bit of the f32 sum."""
    rng = np.random.default_rng(5)
    keys = np.where(rng.random(3000) < 0.8, 13,
                    rng.integers(0, 200, 3000)).astype(np.int32)
    vals = {"x": rng.normal(size=3000).astype(np.float32) * 1e3}
    col = Col.from_numpy(keys, vals, 4, device="cpu")
    rcol = RefCol.from_numpy(keys, vals, 4)
    red, ovf = col.reduce_by_key("sum")
    rred, rovf = jax.jit(lambda c: c.reduce_by_key("sum"))(rcol)
    _col_equal(red, rred, (ovf,), (rovf,))


def test_reduce_by_key_vector_leaf_equals_its_columns():
    """A [N, D] leaf reduces per column (the reference reduces scalar
    leaves only); each column equals its own scalar reduce bit for bit."""
    keys, vals = _inputs(200, 9)
    vec = vals["y"].astype(np.float32) * 0.37
    col = Col.from_numpy(keys, {"v": vec}, 4, device="cpu")
    for op in ("sum", "max"):
        red, _ = col.reduce_by_key(op)
        for j in range(vec.shape[1]):
            one = Col.from_numpy(keys, {"v": vec[:, j]}, 4, device="cpu")
            rj, _ = one.reduce_by_key(op)
            assert torch.equal(red.values["v"][..., j], rj.values["v"])
            assert torch.equal(red.mask, rj.mask)


# ---------------------------------------------------------------- the hash
_EXTREMES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, KEY_PAD,
                      0x5EED, -0x5EED], np.int32)


@pytest.mark.parametrize("p", range(1, 9))
def test_hash_equals_reference(p):
    rng = np.random.default_rng(p)
    x = np.concatenate([_EXTREMES, rng.integers(-2**31, 2**31, 20000)
                        ]).astype(np.int32)
    for salt in (0, 7, 0x5EED):
        got = hash_mod_t(torch.from_numpy(x), p, salt)
        assert got.dtype == torch.int32
        got = got.numpy()
        np.testing.assert_array_equal(
            got, np.asarray(hash_mod_jnp(jnp.asarray(x), p, salt=salt)))
        np.testing.assert_array_equal(got, hash_mod32(x, p, salt))


# ---------------------------------------------------------------- the scan
@pytest.mark.parametrize("op", ["sum", "min", "max", "mul", "callable"])
@pytest.mark.parametrize("n", [1, 2, 7, 8, 4097])
def test_segmented_scan_equals_reference_bits(n, op):
    rng = np.random.default_rng(n)
    vals = (rng.normal(size=n) * 10).astype(np.float32)
    if op == "mul":
        vals = (1 + rng.normal(size=n) * 0.05).astype(np.float32)
    starts = rng.random(n) < 0.05
    starts[0] = True
    fn = (lambda a, b: a * 0.5 + b) if op == "callable" else op
    got = _seg_reduce_sorted(torch.from_numpy(vals), torch.from_numpy(starts),
                             fn)
    want = jax.jit(ref_seg_reduce, static_argnums=2)(
        jnp.asarray(vals), jnp.asarray(starts), fn)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
