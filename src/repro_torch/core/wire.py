"""Wire codecs: what the exchange puts on the wire, and narrow-resident
mirrors (the port of `repro.core.wire`, DESIGN.md §2.1 and §2.4).

Three mechanisms, combinable per `WireCodec`:

  * Per-block scaled quantization (`scaled=True`): a float payload is cut
    into `block`-element tiles along its flattened per-destination axis and
    each tile ships as int8 or fp8 (e4m3 / e5m2) plus one signed 8-bit
    power-of-two exponent (the E8M0 layout of OCP microscaling).  The
    exponent is ceil(log2(absmax / qmax)), clipped to [-126, 126], so the
    dequantization is an exact power-of-two scaling.
  * Exact small-int packing (`pack_ints=True`): signed ints whose static
    bound fits ship as int8 / int16 and widen back on receive.
  * Active-set delta accounting (`delta=True`): `bytes_on_wire` counts only
    the blocks that hold an active entry.

A `resident=True` codec also keeps eligible mirror leaves encoded in device
memory between supersteps (`ResidentLeaf`): payload plus one exponent per
`block` vertex rows per column.  The fused triplet kernel reads the payload
and its scale plane directly (kernels/triplet.py); every other consumer
decodes on read.

Decoding builds 2^e from its exponent bits (`kernels.ref.pow2`), which is
exact for every e in [-126, 126].  The reference multiplies by XLA's exp2,
which on the CPU is exact only for |e| <= 12 (and some even e), so the two
agree bit for bit where every block exponent lies in [-12, 12].
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..kernels.ref import pow2
from .tree import bmask, tree_leaves, tree_map

# Per-block scale on the wire: one signed 8-bit power-of-two exponent.
SCALE_BYTES = 1

_TORCH_INT = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
              np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Static wire-format description (hashable)."""

    name: str
    fdtype: Any = None        # on-wire torch dtype of float leaves; None keeps
    scaled: bool = False      # a per-block power-of-two exponent rides along
    block: int = 32           # elements (or resident rows) per exponent
    pack_ints: bool = True    # signed ints narrow losslessly under the bound
    delta: bool = False       # count only blocks that hold an active entry
    resident: bool = False    # mirrors stay encoded in device memory

    def replace(self, **kw) -> "WireCodec":
        return dataclasses.replace(self, **kw)


def _registry() -> dict:
    return {
        "f32": WireCodec("f32"),
        "bf16": WireCodec("bf16", fdtype=torch.bfloat16),
        "int8": WireCodec("int8", fdtype=torch.int8, scaled=True),
        "fp8_e4m3": WireCodec("fp8_e4m3", fdtype=torch.float8_e4m3fn,
                              scaled=True),
        "fp8_e5m2": WireCodec("fp8_e5m2", fdtype=torch.float8_e5m2,
                              scaled=True),
    }


CODEC_NAMES = tuple(_registry())


def make_codec(spec, *, delta: bool | None = None, block: int | None = None,
               pack_ints: bool | None = None,
               resident: bool | None = None) -> WireCodec | None:
    """Resolve a codec spec: None | "none" | a name of CODEC_NAMES |
    WireCodec, with optional field overrides."""
    if spec is None or spec == "none":
        return None
    if isinstance(spec, WireCodec):
        codec = spec
    else:
        try:
            codec = _registry()[spec]
        except KeyError:
            raise ValueError(
                f"unknown wire codec {spec!r}; one of {CODEC_NAMES}") from None
    kw = {k: v for k, v in (("delta", delta), ("block", block),
                            ("pack_ints", pack_ints), ("resident", resident))
          if v is not None}
    return codec.replace(**kw) if kw else codec


# ---------------------------------------------------------------------------
# Integer width under a payload bound
# ---------------------------------------------------------------------------
def _np_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch or numpy integer (or bool) dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def int_wire_dtype(dtype, bound: int | None) -> np.dtype:
    """Narrowest signed width holding [-bound, bound]; never widens, never
    touches unsigned or bool dtypes, full width when the bound is unknown.
    `dtype`: a torch or numpy integer or bool dtype."""
    dt = _np_dtype(dtype)
    if bound is None or bound <= 0 or dt.kind != "i":
        return dt
    for cand in (np.int8, np.int16):
        c = np.dtype(cand)
        if c.itemsize < dt.itemsize and bound <= np.iinfo(c).max:
            return c
    return dt


def _qmax(wdtype: torch.dtype) -> float:
    if wdtype.is_floating_point:
        return float(torch.finfo(wdtype).max)
    return float(torch.iinfo(wdtype).max)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# Leaf encode / decode (in flight)
# ---------------------------------------------------------------------------
class Encoded(NamedTuple):
    kind: str                         # "narrow" | "scaled" | "int"
    payload: torch.Tensor             # wire dtype
    scale: torch.Tensor | None        # int8 block exponents ("scaled" only)


def encode_leaf(x: torch.Tensor, codec: WireCodec | None, *,
                bound: int | None = None,
                active: torch.Tensor | None = None) -> Encoded | None:
    """Encode one [nl, P, ...] exchange buffer; None ships it as it is.
    `active` ([nl, P, K] bool) zero-substitutes stale entries before the
    quantization, so they neither inflate a block's absmax nor wrap an
    exact int cast."""
    if codec is None or x.numel() == 0 or x.dim() < 2:
        return None
    if x.dtype.is_floating_point:
        if codec.fdtype is None:
            return None
        if active is not None:
            x = torch.where(bmask(active, x), x, torch.zeros_like(x))
        if not codec.scaled:
            if _itemsize(codec.fdtype) >= x.element_size():
                return None
            return Encoded("narrow", x.to(codec.fdtype), None)
        payload, sexp = _encode_scaled(x, codec)
        return Encoded("scaled", payload, sexp)
    wdt = (int_wire_dtype(x.dtype, bound) if codec.pack_ints
           else _np_dtype(x.dtype))
    if wdt.itemsize < x.element_size():
        if active is not None:
            x = torch.where(bmask(active, x), x, torch.zeros_like(x))
        return Encoded("int", x.to(_TORCH_INT[wdt]), None)
    return None


def decode_leaf(kind: str, payload: torch.Tensor, scale: torch.Tensor | None,
                like: torch.Tensor, codec: WireCodec) -> torch.Tensor:
    """Invert encode_leaf after the transpose (`like` is the send buffer).
    "narrow" leaves stay narrow; "scaled" and "int" leaves decode back to
    the original dtype."""
    if kind == "narrow":
        return payload
    if kind == "int":
        return payload.to(like.dtype)
    e = _spread_exponents(scale, payload.shape[-1], codec.block)
    deq = payload.float() * pow2(e)
    return deq.reshape(like.shape).to(like.dtype)


def _spread_exponents(exp: torch.Tensor, k: int, block: int) -> torch.Tensor:
    """[nl, P, nb] int8 block exponents -> [nl, P, k] int32 per element."""
    return exp.to(torch.int32).repeat_interleave(block, dim=-1)[..., :k]


def _quantize(flat: torch.Tensor, e: torch.Tensor,
              wdtype: torch.dtype) -> torch.Tensor:
    """flat / 2^e clipped into +-qmax and cast; an integer payload rounds
    but never to zero from a nonzero input (consumers divide by shipped
    properties: PageRank's deg)."""
    qmax = min(_qmax(wdtype), float(np.finfo(np.float32).max))
    q = torch.clamp(flat * pow2(-e), -qmax, qmax)
    if not wdtype.is_floating_point:
        q = torch.where(flat != 0, torch.sign(flat) * torch.clamp_min(
            torch.round(q.abs()), 1.0), 0.0)
    return q.to(wdtype)


def _block_exponents(absmax: torch.Tensor, wdtype: torch.dtype) -> torch.Tensor:
    """ceil(log2(max(absmax, 1e-30) / qmax)), 0 for an all-zero block,
    clipped to [-126, 126], as int8 (the reference's rule)."""
    qmax = min(_qmax(wdtype), float(np.finfo(np.float32).max))
    exp = torch.ceil(torch.log2(torch.clamp_min(absmax, 1e-30) / qmax))
    exp = torch.clamp(torch.where(absmax > 0, exp, 0.0), -126, 126)
    return exp.to(torch.int8)


def _encode_scaled(x: torch.Tensor, codec: WireCodec):
    """Per-block absmax quantization with power-of-two exponents along the
    flattened per-destination axis; the payload ships unpadded."""
    nl, p = x.shape[:2]
    flat = x.float().reshape(nl, p, -1)
    k = flat.shape[-1]
    nb = max(-(-k // codec.block), 1)
    padded = torch.nn.functional.pad(flat, (0, nb * codec.block - k))
    absmax = padded.reshape(nl, p, nb, codec.block).abs().amax(dim=-1)
    exp = _block_exponents(absmax, codec.fdtype)
    q = _quantize(flat, _spread_exponents(exp, k, codec.block), codec.fdtype)
    return q, exp


# ---------------------------------------------------------------------------
# Narrow-resident mirror leaves (DESIGN.md §2.4)
# ---------------------------------------------------------------------------
class ResidentLeaf:
    """One mirror leaf kept encoded in device memory.

    payload: [nl, V, ...] in the narrow dtype (int8 / fp8 for "scaled"
    floats, the packed signed width for "int"); scale: [nl, ceil(V/block),
    d] int8 exponents ("scaled" only; d = trailing element count).  Reports
    the dtype and shape of the decoded leaf, so structural checks treat it
    as the leaf it stands for.  Not a registered pytree node: the port's
    tree helpers see it as one leaf."""

    __slots__ = ("payload", "scale", "kind", "dtype", "block")

    def __init__(self, payload: torch.Tensor, scale: torch.Tensor | None,
                 kind: str, dtype: torch.dtype, block: int = 32):
        self.payload = payload
        self.scale = scale
        self.kind = kind              # "scaled" | "int"
        self.dtype = dtype
        self.block = block

    @property
    def shape(self) -> torch.Size:
        return self.payload.shape

    def hbm_nbytes(self) -> int:
        """Resident bytes: payload plus exponents."""
        n = self.payload.numel() * self.payload.element_size()
        if self.scale is not None:
            n += self.scale.numel() * self.scale.element_size()
        return n

    def decode(self) -> torch.Tensor:
        """The whole leaf in its original dtype."""
        if self.kind == "int":
            return self.payload.to(self.dtype)
        nl, v = self.payload.shape[:2]
        flat = self.payload.float().reshape(nl, v, -1)
        e = self.scale.to(torch.int32).repeat_interleave(self.block,
                                                         dim=1)[:, :v]
        return (flat * pow2(e)).reshape(self.payload.shape).to(self.dtype)

    def __repr__(self):
        return (f"ResidentLeaf({self.kind}, {self.dtype}, "
                f"shape={tuple(self.payload.shape)})")


def is_resident(x) -> bool:
    return isinstance(x, ResidentLeaf)


def resident_kind(dtype: torch.dtype, codec: WireCodec | None,
                  bound: int | None) -> str | None:
    """Can a mirror leaf of `dtype` stay encoded?  Floats under a scaled
    codec ("scaled"), signed ints the wire would narrow losslessly
    ("int"); anything else (bf16 mirrors are already narrow) stays as it
    is."""
    if codec is None or not codec.resident:
        return None
    if dtype.is_floating_point:
        return "scaled" if codec.scaled and codec.fdtype is not None else None
    ndt = _np_dtype(dtype)
    if ndt.kind == "i" and codec.pack_ints:
        if int_wire_dtype(ndt, bound).itemsize < ndt.itemsize:
            return "int"
    return None


def encode_resident(x, codec: WireCodec, kind: str, *,
                    bound: int | None = None) -> ResidentLeaf:
    """Encode one [nl, V, ...] mirror leaf for residency: "int" is the
    lossless cast; "scaled" quantizes per `block` vertex rows and column
    with the exponent rule of `_encode_scaled`.  Decode then re-encode of
    an unchanged block is value-exact; a block a scatter touched
    re-quantizes its stale rows against its new absmax (at most one
    quantization step, the §2.4 drift contract)."""
    if isinstance(x, ResidentLeaf):
        return x
    if kind == "int":
        wdt = _TORCH_INT[int_wire_dtype(x.dtype, bound)]
        return ResidentLeaf(x.to(wdt), None, "int", x.dtype, codec.block)
    if kind != "scaled":
        raise ValueError(f"resident kind {kind!r}")
    nl, v = x.shape[:2]
    flat = x.float().reshape(nl, v, -1)
    d = flat.shape[-1]
    nb = max(-(-v // codec.block), 1)
    padded = torch.nn.functional.pad(flat, (0, 0, 0, nb * codec.block - v))
    absmax = padded.reshape(nl, nb, codec.block, d).abs().amax(dim=2)
    exp = _block_exponents(absmax, codec.fdtype)
    e = exp.to(torch.int32).repeat_interleave(codec.block, dim=1)[:, :v]
    q = _quantize(flat, e, codec.fdtype)
    return ResidentLeaf(q.reshape(x.shape), exp, "scaled", x.dtype,
                        codec.block)


def decode_resident(x):
    """ResidentLeaf -> its decoded tensor; anything else passes through."""
    return x.decode() if isinstance(x, ResidentLeaf) else x


def decode_tree(tree):
    """Decode every resident leaf of a mirror pytree."""
    return tree_map(decode_resident, tree)


def resident_hbm_bytes(tree) -> int:
    """Device bytes of a mirror pytree: encoded leaves count payload and
    exponents, plain leaves their full width (`mirror_hbm_bytes`)."""
    return sum(x.hbm_nbytes() if isinstance(x, ResidentLeaf)
               else x.numel() * x.element_size() for x in tree_leaves(tree))


# ---------------------------------------------------------------------------
# Byte accounting (ShipMetrics.wire_bytes / bytes_accounted)
# ---------------------------------------------------------------------------
def _leaf_layout(x, codec: WireCodec | None, bound: int | None):
    """(bytes per element on the wire, exponent bytes per block or 0)."""
    item = _itemsize(x.dtype)
    if codec is None:
        return item, 0
    if x.dtype.is_floating_point:
        if codec.fdtype is None:
            return item, 0
        w = _itemsize(codec.fdtype)
        if codec.scaled:
            return w, SCALE_BYTES
        return min(item, w), 0
    if codec.pack_ints:
        return int_wire_dtype(x.dtype, bound).itemsize, 0
    return item, 0


def _numel(x) -> int:
    return int(np.prod(tuple(x.shape), dtype=np.int64))


def static_wire_bytes(tree, codec: WireCodec | None,
                      bound: int | None = None) -> int:
    """Bytes the collective moves under the codec: narrowed or quantized
    payload plus one exponent per block of each destination's payload.
    Leaves may be tensors or anything with `shape` and `dtype`."""
    total = 0
    for x in tree_leaves(tree):
        w, sb = _leaf_layout(x, codec, bound)
        n = _numel(x)
        total += n * w
        if sb and len(x.shape) >= 2 and n:
            nl, p = x.shape[:2]
            k = n // max(nl * p, 1)
            total += nl * p * max(-(-k // codec.block), 1) * sb
    return total


def bytes_on_wire(tree, codec: WireCodec | None,
                  active: torch.Tensor | None = None,
                  bound: int | None = None):
    """The volume a zero-run-compressing transport would move: the static
    count, or under a delta codec with an active mask ([nl, P, K]) only
    the blocks that hold an active entry pay their payload and exponent
    bytes (an int64 tensor on the mask's device then)."""
    static = static_wire_bytes(tree, codec, bound)
    if codec is None or not codec.delta or active is None:
        return static
    total = torch.zeros((), dtype=torch.int64, device=active.device)
    for x in tree_leaves(tree):
        if x.numel() == 0 or x.dim() < 3:
            continue
        w, sb = _leaf_layout(x, codec, bound)
        nl, p = x.shape[:2]
        elems = _numel(x) // max(nl * p * x.shape[2], 1)
        ae = active[..., None].expand(active.shape + (elems,)).reshape(nl, p, -1)
        k = ae.shape[-1]
        nb = max(-(-k // codec.block), 1)
        ae = torch.nn.functional.pad(ae, (0, nb * codec.block - k))
        blk_active = ae.reshape(nl, p, nb, codec.block).any(dim=-1)
        sizes = torch.full((nb,), codec.block, dtype=torch.int64,
                           device=active.device)
        sizes[-1] = k - (nb - 1) * codec.block
        total = total + (blk_active * (sizes * w + sb)).sum()
    return total
