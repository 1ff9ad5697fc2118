"""Wire codecs of the PyTorch port against the reference (`core/wire.py`).

Encoded payloads and exponents are byte-identical to the reference's, and
decoded values equal, wherever every block exponent lies in [-12, 12]: the
data below is drawn so that they do, and each test checks it.  Outside that
range the reference's CPU arithmetic differs from the exact rule, and the
last tests pin those differences as facts of the reference:

  * XLA's exp2 on the CPU is inexact at integer exponents with |k| > 12
    (the port builds 2^k from its exponent bits, exact on [-126, 126]);
  * XLA's and torch's log2 round differently at a few boundary inputs, so
    the block exponent ceil(log2(absmax / qmax)) differs there.

Byte accounting (`static_wire_bytes`, `bytes_on_wire` with and without
delta) equals the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import LocalExchange as RefLocalExchange  # noqa: E402
from repro.core import wire as RW  # noqa: E402
from repro.core import with_wire as ref_with_wire  # noqa: E402
from repro_torch.core import LocalExchange, with_wire  # noqa: E402
from repro_torch.core import wire as W  # noqa: E402
from repro_torch.kernels.ref import pow2  # noqa: E402

SCALED = ("int8", "fp8_e4m3", "fp8_e5m2")
# magnitudes whose block exponents ceil(log2(absmax / qmax)) lie in
# [-12, 12] for each codec's qmax (127, 448, 57344)
MAGNITUDE = {"int8": (0.05, 4e4), "fp8_e4m3": (0.1, 1e5),
             "fp8_e5m2": (10.0, 1e6)}


def _bytes(a) -> np.ndarray:
    """Raw bytes of a torch or jax array (fp8 included)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _data(shape, name, seed, integer=False):
    """Random floats, each block scaled into the codec's exponent range;
    or integer-valued floats (degree counts, |v| <= qmax of int8)."""
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-127, 128, size=shape).astype(np.float32)
    lo, hi = MAGNITUDE.get(name, (0.05, 4e4))
    mag = np.exp(rng.uniform(np.log(lo), np.log(hi), size=shape[:-1] + (1,)))
    return (rng.uniform(-1, 1, size=shape) * mag).astype(np.float32)


def _in_range(scale):
    e = np.asarray(scale if not isinstance(scale, torch.Tensor)
                   else scale.numpy()).astype(np.int64)
    assert e.min() >= -12 and e.max() <= 12, (e.min(), e.max())


def test_registry_and_with_wire_match_reference():
    assert W.CODEC_NAMES == RW.CODEC_NAMES
    for name in W.CODEC_NAMES:
        c, rc = W.make_codec(name), RW.make_codec(name)
        for f in ("name", "scaled", "block", "pack_ints", "delta",
                  "resident"):
            assert getattr(c, f) == getattr(rc, f), (name, f)
        assert (c.fdtype is None) == (rc.fdtype is None)
        if c.fdtype is not None:
            assert torch.empty((), dtype=c.fdtype).element_size() == \
                jnp.dtype(rc.fdtype).itemsize
    ex = with_wire(LocalExchange(4), "int8", delta=True, resident=True)
    assert ex.codec.name == "int8" and ex.codec.delta and ex.codec.resident
    assert with_wire(ex, None).codec is None
    assert LocalExchange(4).codec is None
    with pytest.raises(ValueError, match="unknown wire codec"):
        W.make_codec("int4")


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("shape", [(4, 4, 40), (4, 4, 13, 3)])
@pytest.mark.parametrize("name", ("bf16",) + SCALED)
def test_encode_leaf_byte_identical(name, shape, integer):
    """The wire encode (with stale entries zero-substituted) gives the
    reference's payload bytes and exponents; decode gives its values."""
    x = _data(shape, name, seed=len(shape) * 7 + integer, integer=integer)
    active = np.random.default_rng(9).random(shape[:3]) < 0.8
    codec, rcodec = W.make_codec(name), RW.make_codec(name)
    enc = W.encode_leaf(torch.from_numpy(x), codec,
                        active=torch.from_numpy(active))
    renc = RW.encode_leaf(jnp.asarray(x), rcodec, active=jnp.asarray(active))
    assert enc.kind == renc.kind
    np.testing.assert_array_equal(_bytes(enc.payload), _bytes(renc.payload))
    if enc.scale is not None:
        _in_range(enc.scale)
        np.testing.assert_array_equal(enc.scale.numpy(),
                                      np.asarray(renc.scale))
    got = W.decode_leaf(enc.kind, enc.payload, enc.scale,
                        torch.from_numpy(x), codec)
    want = RW.decode_leaf(renc.kind, renc.payload, renc.scale,
                          jnp.asarray(x), rcodec)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    if integer and name == "int8":
        np.testing.assert_array_equal(got.numpy(), x * active.reshape(
            active.shape + (1,) * (x.ndim - 3)))


@pytest.mark.parametrize("bound,width", [(100, 1), (30_000, 2), (1 << 20, 4),
                                         (None, 4)])
def test_int_packing_matches_reference(bound, width):
    rng = np.random.default_rng(4)
    hi = min(bound or 1000, 1 << 20)
    ids = rng.integers(-hi, hi + 1, size=(4, 4, 20)).astype(np.int32)
    codec, rcodec = W.make_codec("int8"), RW.make_codec("int8")
    enc = W.encode_leaf(torch.from_numpy(ids), codec, bound=bound)
    renc = RW.encode_leaf(jnp.asarray(ids), rcodec, bound=bound)
    assert (enc is None) == (renc is None) == (width == 4)
    assert W.int_wire_dtype(torch.int32, bound) == \
        RW.int_wire_dtype(np.int32, bound)
    if enc is None:
        return
    assert enc.kind == renc.kind == "int"
    assert enc.payload.element_size() == width
    np.testing.assert_array_equal(enc.payload.numpy(), np.asarray(renc.payload))
    dec = W.decode_leaf("int", enc.payload, None, torch.from_numpy(ids), codec)
    assert dec.dtype == torch.int32
    np.testing.assert_array_equal(dec.numpy(), ids)
    # unsigned bit patterns never narrow; narrow ints never widen
    assert W.encode_leaf(torch.ones((4, 4, 8), dtype=torch.uint8), codec,
                         bound=3) is None
    assert W.int_wire_dtype(torch.int16, 100) == np.int8
    assert W.int_wire_dtype(torch.int8, 3) == np.int8


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("shape", [(4, 70), (3, 33, 2), (4, 32, 3)])
@pytest.mark.parametrize("name", SCALED)
def test_encode_resident_byte_identical(name, shape, integer):
    """Resident encode (per 32 vertex rows and column) gives the
    reference's payload and exponents; the decode its values."""
    x = _data(shape, name, seed=sum(shape) + integer, integer=integer)
    codec = W.make_codec(name, resident=True)
    rcodec = RW.make_codec(name, resident=True)
    leaf = W.encode_resident(torch.from_numpy(x), codec, "scaled")
    rleaf = RW.encode_resident(jnp.asarray(x), rcodec, "scaled")
    _in_range(leaf.scale)
    np.testing.assert_array_equal(_bytes(leaf.payload), _bytes(rleaf.payload))
    np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(rleaf.scale))
    assert leaf.dtype == torch.float32 and tuple(leaf.shape) == shape
    assert leaf.hbm_nbytes() == rleaf.hbm_nbytes()
    np.testing.assert_array_equal(leaf.decode().numpy(),
                                  np.asarray(rleaf.decode()))
    assert W.decode_resident(leaf).dtype == torch.float32
    # decode -> encode of an unchanged leaf is value-exact
    again = W.encode_resident(leaf.decode(), codec, "scaled")
    np.testing.assert_array_equal(again.decode().numpy(),
                                  leaf.decode().numpy())


def test_resident_kinds_and_int_leaves_match_reference():
    for name in W.CODEC_NAMES:
        codec = W.make_codec(name, resident=True)
        rcodec = RW.make_codec(name, resident=True)
        for tdt, ndt in ((torch.float32, np.float32), (torch.int32, np.int32),
                         (torch.int16, np.int16), (torch.uint8, np.uint8),
                         (torch.bool, np.bool_)):
            for bound in (None, 100, 32767):
                assert W.resident_kind(tdt, codec, bound) == \
                    RW.resident_kind(ndt, rcodec, bound), (name, tdt, bound)
    assert W.resident_kind(torch.float32, W.make_codec("int8"), None) is None
    ids = np.arange(-60, 80, dtype=np.int32).reshape(2, 70)
    codec = W.make_codec("int8", resident=True)
    leaf = W.encode_resident(torch.from_numpy(ids), codec, "int", bound=100)
    rleaf = RW.encode_resident(jnp.asarray(ids),
                               RW.make_codec("int8", resident=True), "int",
                               bound=100)
    assert leaf.payload.dtype == torch.int8 and leaf.scale is None
    np.testing.assert_array_equal(leaf.payload.numpy(),
                                  np.asarray(rleaf.payload))
    np.testing.assert_array_equal(leaf.decode().numpy(), ids)
    assert W.resident_hbm_bytes({"a": leaf, "b": torch.zeros(2, 70)}) == \
        RW.resident_hbm_bytes({"a": rleaf, "b": jnp.zeros((2, 70))})


def test_ship_equals_reference_ship():
    """Exchange.ship through each codec equals the reference's ship."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4, 4, 21)) * 30).astype(np.float32)
    for name in ("bf16",) + SCALED:
        ex = with_wire(LocalExchange(4), name)
        rex = ref_with_wire(RefLocalExchange(4), name)
        if name == "fp8_e5m2":
            x = x * 100
        got = ex.ship(torch.from_numpy(x))
        want = rex.ship(jnp.asarray(x))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def _tree(rng):
    return {"a": rng.normal(size=(4, 4, 40)).astype(np.float32),
            "b": rng.normal(size=(4, 4, 40, 3)).astype(np.float32),
            "i": rng.integers(0, 90, size=(4, 4, 40)).astype(np.int32),
            "u": rng.integers(0, 9, size=(4, 4, 40)).astype(np.uint8)}


@pytest.mark.parametrize("bound", [None, 100, 40_000])
@pytest.mark.parametrize("name", (None,) + W.CODEC_NAMES)
def test_static_wire_bytes_match_reference(name, bound):
    rng = np.random.default_rng(6)
    tree = _tree(rng)
    codec, rcodec = W.make_codec(name), RW.make_codec(name)
    got = W.static_wire_bytes({k: torch.from_numpy(v) for k, v in tree.items()},
                              codec, bound)
    want = RW.static_wire_bytes({k: jnp.asarray(v) for k, v in tree.items()},
                                rcodec, bound)
    assert got == want


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("name", W.CODEC_NAMES)
def test_bytes_on_wire_match_reference(name, delta):
    rng = np.random.default_rng(7)
    tree = _tree(rng)
    codec = W.make_codec(name, delta=delta)
    rcodec = RW.make_codec(name, delta=delta)
    for frac in (0.0, 0.02, 0.5, 1.0):
        active = rng.random((4, 4, 40)) < frac
        got = W.bytes_on_wire(
            {k: torch.from_numpy(v) for k, v in tree.items()}, codec,
            torch.from_numpy(active), 100)
        want = RW.bytes_on_wire({k: jnp.asarray(v) for k, v in tree.items()},
                                rcodec, jnp.asarray(active), 100)
        assert int(got) == float(want), (frac, int(got), float(want))
    assert W.bytes_on_wire(tree_t := {"a": torch.ones(2, 2, 8)}, codec) == \
        W.static_wire_bytes(tree_t, codec)


# ---------------------------------------------------------------------------
# The reference's CPU arithmetic, pinned as facts of the reference
# ---------------------------------------------------------------------------
def test_reference_exp2_inexact_outside_twelve_port_exact():
    """XLA's exp2 on the CPU misses 2^k at integer k, but only for |k| >
    12; the port's pow2 is exact on [-126, 126].  A resident block with
    exponent -20 therefore decodes exactly in the port and not in the
    reference."""
    ks = np.arange(-126, 127)
    exact = np.ldexp(np.float32(1), ks).astype(np.float32)
    ref = np.asarray(jnp.exp2(jnp.asarray(ks, jnp.float32)))
    wrong = ks[ref != exact]
    assert len(wrong) > 100 and np.abs(wrong).min() == 13, wrong
    np.testing.assert_array_equal(pow2(torch.from_numpy(ks)).numpy(), exact)
    # one block of 32 rows with absmax 0.01 under int8: exponent -13
    x = np.linspace(-0.01, 0.01, 32, dtype=np.float32).reshape(1, 32)
    codec = W.make_codec("int8", resident=True)
    leaf = W.encode_resident(torch.from_numpy(x), codec, "scaled")
    rleaf = RW.encode_resident(jnp.asarray(x),
                               RW.make_codec("int8", resident=True), "scaled")
    assert int(leaf.scale.reshape(-1)[0]) == -13
    assert int(np.asarray(rleaf.scale).reshape(-1)[0]) == -13
    exact_dec = np.ldexp(leaf.payload.numpy().astype(np.float32), -13)
    np.testing.assert_array_equal(leaf.decode().numpy(), exact_dec)
    assert not np.array_equal(np.asarray(rleaf.decode()), exact_dec)


# (k, ulps above 2^k) of absmax / qmax where XLA's and torch's CPU log2
# round to different block exponents (reference, port)
LOG2_BOUNDARY = [(-15, 0, -14, -15), (-13, 0, -12, -13), (-5, 1, -4, -5),
                 (3, 1, 3, 4)]


@pytest.mark.parametrize("k,ulps,ref_exp,port_exp", LOG2_BOUNDARY)
def test_reference_log2_boundaries_encode_differently(k, ulps, ref_exp,
                                                      port_exp):
    """At these absmax / qmax inputs the two libraries' ceil(log2(.))
    disagree, so the same block encodes with different exponents: XLA is
    one too high at 2^-15 and 2^-13 exactly, torch rounds log2 down one ulp
    above 2^-5 and XLA one ulp above 2^3."""
    m = np.float32(2.0 ** k)
    for _ in range(ulps):
        m = np.nextafter(m, np.float32(np.inf), dtype=np.float32)
    qmax = np.float32(127)
    cands = [np.float32(m * qmax)]
    for _ in range(8):
        cands += [np.nextafter(cands[-1], np.float32(np.inf),
                               dtype=np.float32)]
        cands += [np.nextafter(cands[0], np.float32(0), dtype=np.float32)]
    absmax = next(a for a in cands if np.float32(a / qmax) == m)
    x = np.zeros((1, 32), np.float32)
    x[0, 5] = absmax
    codec = W.make_codec("int8", resident=True)
    got = W.encode_resident(torch.from_numpy(x), codec, "scaled")
    want = RW.encode_resident(jnp.asarray(x),
                              RW.make_codec("int8", resident=True), "scaled")
    assert int(np.asarray(want.scale).reshape(-1)[0]) == ref_exp
    assert int(got.scale.reshape(-1)[0]) == port_exp
