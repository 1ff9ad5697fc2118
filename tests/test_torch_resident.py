"""Narrow-resident mirrors and the wire codecs end to end: the port against
the reference on PageRank and connected components.

  * PageRank, 5 supersteps, under every codec, with resident mirrors and
    without, fused ("auto") and unfused: the normalised ranks agree with
    the reference's under the same codec within `_rank_tol` (see there),
    the byte accounting (`wire_bytes`,
    `bytes_accounted`, `bytes_shipped`) is equal per superstep, and so is
    `mirror_hbm_bytes` (the reference's view footprint).  The port's fused
    and unfused runs are bit-equal under each codec.
  * Connected components with an int16-packed resident mirror is
    bit-exact; bf16 with resident=True is a no-op.
  * The triplet kernel's plain version on (payload, scale plane) equals it
    on the decoded rows, and the fused plan hands the kernel the encoded
    mirror.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import algorithms as ref_alg  # noqa: E402
from repro.core import wire as RW  # noqa: E402
from repro.core import with_wire as ref_with_wire  # noqa: E402
from repro.data import rmat, symmetrize  # noqa: E402
from repro_torch.core import Graph, with_wire  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import mrtriplets as mt  # noqa: E402
from repro_torch.core import wire as W  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

GD = rmat(8, 8, seed=3)
ITERS = 5
# largest relative spacing of each codec's values near a block's absmax:
# bf16 and fp8 by their mantissa bits, int8 one code in 127 of a block
# whose absmax is at least half the scale (2 / 127)
SPACING = {"f32": 0.0, "bf16": 2.0 ** -7, "int8": 2 / 127,
           "fp8_e4m3": 2.0 ** -3, "fp8_e5m2": 2.0 ** -2}


def _rank_tol(codec, max_rank):
    """Limit on max |normalised rank difference|, port vs reference under
    one codec.  The f32 sums are added in another order (ulps apart,
    1e-7), and under a narrowing codec a sum a few ulps apart, or at an
    exact tie that the reference's inexact exp2 tips (the exponents of
    fp8_e5m2 lie outside [-12, 12]), can round to the neighbouring code:
    measured, one such flip of one mirror or aggregate value within 5
    supersteps, spread over its out-neighbours.  Two spacings of the
    largest rank bound that, and no more."""
    return 1e-7 + 2 * SPACING[codec] * max_rank


CASES = [(c, r) for c in ("f32", "bf16", "int8", "fp8_e4m3", "fp8_e5m2")
         for r in (False, True)]


@functools.lru_cache(maxsize=None)
def _graphs():
    return (Graph.from_edges(GD.src, GD.dst, num_partitions=4, device="cpu"),
            RefGraph.from_edges(GD.src, GD.dst, num_partitions=4))


@functools.lru_cache(maxsize=None)
def _ref_run(codec, resident):
    _, rg = _graphs()
    rg = rg.replace(ex=ref_with_wire(rg.ex, codec, resident=resident))
    return ref_alg.pagerank(rg, num_iters=ITERS, track_metrics=True)


@functools.lru_cache(maxsize=None)
def _port_run(codec, resident, mode):
    g, _ = _graphs()
    g = g.replace(ex=with_wire(g.ex, codec, resident=resident))
    return alg.pagerank(g, num_iters=ITERS, track_metrics=True,
                        kernel_mode=mode)


def _norm(vdata, vmask):
    pr = np.asarray(vdata["pr"], np.float64)[np.asarray(vmask)]
    return pr / pr.sum()


_FIELDS = ("wire_bytes", "bytes_accounted", "bytes_shipped")


@pytest.mark.parametrize("mode", ["auto", "unfused"])
@pytest.mark.parametrize("codec,resident", CASES)
def test_pagerank_codec_matches_reference(codec, resident, mode):
    r = _port_run(codec, resident, mode)
    rr = _ref_run(codec, resident)
    g, rg = _graphs()
    want = _norm(rr.graph.vdata, rg.vmask)
    err = np.abs(_norm(r.graph.vdata, g.vmask) - want).max()
    assert err <= _rank_tol(codec, want.max()), err
    assert r.supersteps == rr.supersteps == ITERS
    want_plan = ("fused", "fused_apply") if mode == "auto" else \
        ("unfused", "unfused")
    hbm = RW.resident_hbm_bytes(rr.graph.view.mirror)
    for m, rm in zip(r.metrics, rr.metrics):
        assert m["wire"] == rm["wire"] == codec
        assert (m["plan"], m["apply_plan"]) == want_plan
        for side in ("fwd", "back"):
            for f in _FIELDS:
                assert m[side][f] == float(getattr(rm[side], f)), (side, f)
        assert m["bytes_on_wire"] == rm["bytes_on_wire"]
        assert m["bytes_shipped"] == rm["bytes_shipped"]
        assert m["mirror_hbm_bytes"] == hbm
    encoded = [l for l in W.tree_leaves(r.graph.view.mirror)
               if W.is_resident(l)]
    assert bool(encoded) == (resident and codec not in ("f32", "bf16"))


@pytest.mark.parametrize("codec,resident", CASES)
def test_pagerank_codec_fused_equals_unfused(codec, resident):
    a = _port_run(codec, resident, "auto")
    b = _port_run(codec, resident, "unfused")
    assert torch.equal(a.graph.vdata["pr"], b.graph.vdata["pr"])
    assert [m["bytes_shipped"] for m in a.metrics] == \
        [m["bytes_shipped"] for m in b.metrics]


@pytest.mark.parametrize("codec", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_resident_footprint_and_drift_against_wire_only(codec):
    """The resident view holds <= 0.35x the wire-only view's bytes, and
    residency drifts at most one quantization step per refresh: relative
    L2 <= ITERS / 254 against the wire-only run (the reference's §2.4
    contract, tests/test_view.py).  Under int8 the normalised ranks stay
    within 1e-3 of the f32 wire's (the reference's
    test_pagerank_int8_wire_error_and_bytes_regression)."""
    res, wire = _port_run(codec, True, "auto"), _port_run(codec, False, "auto")
    assert res.metrics[-1]["mirror_hbm_bytes"] <= \
        0.35 * wire.metrics[-1]["mirror_hbm_bytes"]
    a = res.graph.vdata["pr"].double()
    b = wire.graph.vdata["pr"].double()
    assert float((a - b).norm() / b.norm()) <= ITERS / 254
    if codec != "int8":
        return
    f32 = _port_run("f32", False, "auto")
    g, _ = _graphs()
    assert np.abs(_norm(res.graph.vdata, g.vmask)
                  - _norm(f32.graph.vdata, g.vmask)).max() <= 1e-3


def test_bf16_resident_is_a_no_op():
    a, b = _port_run("bf16", True, "auto"), _port_run("bf16", False, "auto")
    assert torch.equal(a.graph.vdata["pr"], b.graph.vdata["pr"])
    assert not any(W.is_resident(l)
                   for l in W.tree_leaves(a.graph.view.mirror))


@pytest.mark.parametrize("mode", ["auto", "unfused"])
def test_cc_int_resident_bit_exact(mode):
    """CC labels through an int16-packed resident mirror (the id bound) with
    delta accounting: bit-equal to the plain wire, to the reference under
    the same codec, and to union-find; byte accounting equal."""
    sgd = symmetrize(rmat(7, 4, seed=2))
    sg = Graph.from_edges(sgd.src, sgd.dst, num_partitions=4, device="cpu")
    rsg = RefGraph.from_edges(sgd.src, sgd.dst, num_partitions=4)
    kw = dict(delta=True, resident=True)
    r = alg.connected_components(sg.replace(ex=with_wire(sg.ex, "int8", **kw)),
                                 kernel_mode=mode, track_metrics=True)
    r0 = alg.connected_components(sg, kernel_mode=mode)
    rr = ref_alg.connected_components(
        rsg.replace(ex=ref_with_wire(rsg.ex, "int8", **kw)),
        track_metrics=True)
    assert torch.equal(r.graph.vdata["cc"], r0.graph.vdata["cc"])
    np.testing.assert_array_equal(r.graph.vdata["cc"].numpy(),
                                  np.asarray(rr.graph.vdata["cc"]))
    assert r.supersteps == rr.supersteps
    ids, vals = r.graph.vertices_to_numpy()
    want = alg.connected_components_reference(sgd.src, sgd.dst, ids)
    assert dict(zip(ids.tolist(), vals["cc"].tolist())) == want
    leaves = [l for l in W.tree_leaves(r.graph.view.mirror) if W.is_resident(l)]
    assert leaves and all(l.kind == "int" and l.payload.dtype == torch.int16
                          for l in leaves)
    for m, rm in zip(r.metrics, rr.metrics):
        assert m["bytes_on_wire"] == rm["bytes_on_wire"]
        assert m["bytes_shipped"] == rm["bytes_shipped"]
        assert m["mirror_hbm_bytes"] == RW.resident_hbm_bytes(
            rr.graph.view.mirror)
    bows = [m["bytes_on_wire"] for m in r.metrics]
    assert bows[-1] < bows[0]


@pytest.mark.parametrize("reduce", ["sum", "min"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16,
                                   torch.float8_e4m3fn, torch.float8_e5m2,
                                   torch.bfloat16])
def test_plain_triplet_on_encoded_rows_equals_decoded(dtype, reduce):
    """The plain fused_triplet on (payload, xscale) equals it on the
    decoded f32 rows, exponents of 32-row groups per partition included."""
    g, _ = _graphs()
    gp = alg.attach_out_degree(g).mapV(alg._pr_init)
    spec = mt.fused_plan(gp, alg.pagerank_send, reduce).kernel
    s = g.s
    nl, v_mir = s.p, s.v_mir
    rng = np.random.default_rng(11)
    nb = -(-v_mir // ref.SCALE_GROUP)
    if dtype == torch.bfloat16:
        x = torch.from_numpy(rng.normal(size=(nl * v_mir, 2)).astype(
            np.float32)).to(dtype)
        xscale = None
    else:
        hi = 100 if dtype.is_floating_point else (
            127 if dtype == torch.int8 else 3000)
        x = torch.from_numpy(rng.integers(1, hi, size=(nl * v_mir, 2))
                             .astype(np.float32)).to(dtype)
        xscale = torch.from_numpy(rng.integers(-20, 20, size=(nl * nb, 2))
                                  .astype(np.int8))
    dec = ref.dequant_rows(x, xscale, nl)
    e = xscale.reshape(nl, nb, 2).repeat_interleave(32, 1)[:, :v_mir] \
        .reshape(-1, 2).numpy().astype(np.float64) if xscale is not None \
        else 0.0
    np.testing.assert_array_equal(
        dec.numpy(), (x.float().numpy() * np.exp2(e)).astype(np.float32))
    args = (g.edata["w"].reshape(-1, 1), s.src_slot, s.dst_slot, g.emask,
            s.agg_ptr["dst"], None, spec)
    got = ref.fused_triplet(x, *args, reduce=reduce, xscale=xscale)
    want = ref.fused_triplet(dec, *args, reduce=reduce)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and through the kernel wrapper on CPU tensors
    got = ops.triplet(x, *args, reduce=reduce, xscale=xscale)
    assert torch.equal(got[0], want[0])


def test_fused_plan_reads_the_encoded_mirror(monkeypatch):
    """Under a resident codec the fused sweep gets the narrow payload and
    its scale plane [nl * ceil(V_mir / 32), D], not a decoded copy."""
    seen = []
    real = ops.triplet

    def spy(x, *a, xscale=None, **kw):
        seen.append((x.dtype, None if xscale is None else tuple(xscale.shape)))
        return real(x, *a, xscale=xscale, **kw)

    monkeypatch.setattr(ops, "triplet", spy)
    _port_run.cache_clear()
    try:
        _port_run("fp8_e4m3", True, "auto")
    finally:
        _port_run.cache_clear()
    g, _ = _graphs()
    nb = -(-g.s.v_mir // 32)
    # degree (no vertex reads) then the PageRank send reading deg and pr
    assert seen[0] == (torch.float32, None)
    assert set(seen[1:]) == {(torch.float8_e4m3fn, (4 * nb, 2))}


def test_pack_cols_stages_bf16_only_when_every_leaf_is_bf16():
    t = {"a": torch.ones(2, 5, dtype=torch.bfloat16),
         "b": torch.ones(2, 5, dtype=torch.bfloat16),
         "c": torch.ones(2, 5)}
    dev = torch.device("cpu")
    assert mt._pack_cols(t, (True, True, False), 2, 5, dev,
                         keep_bf16=True).dtype == torch.bfloat16
    assert mt._pack_cols(t, (True, False, True), 2, 5, dev,
                         keep_bf16=True).dtype == torch.float32
    assert mt._pack_cols(t, (True, True, False), 2, 5, dev).dtype == \
        torch.float32
    leaf = W.encode_resident(torch.ones(2, 5), W.make_codec(
        "int8", resident=True), "scaled")
    assert mt._pack_cols_encoded({"a": leaf, "c": torch.ones(2, 5)},
                                 (True, True), 2, 5) is None
    x, sc = mt._pack_cols_encoded({"a": leaf, "c": torch.ones(2, 5)},
                                  (True, False), 2, 5)
    assert x.dtype == torch.int8 and sc.shape == (2, 1, 1)
    assert jax is not None
