"""Plain PyTorch versions of the port's kernels.

Same arguments and same results as the CUDA kernels in csrc/.  The CPU path
and the tests run these; on the card `chip_smoke.py` holds each kernel
against them.  They run on any device.  On the CPU `index_add_` adds in
index order, so the fused and unfused plain versions agree bit for bit; on
the card `index_add_` uses atomics, so there they agree with the kernels
only within f32 rounding (`sum_tol`).

`ordered_segment_reduce` is not a plain version but the exact model of the
order the triplet and segment_sum kernels sum in (`csrc/segorder.cuh`): the
card checks hold both kernels to it bit for bit.  For a segment of at most
SEG_PIECE entries that order is the sequential one `index_add_` follows on
the CPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import segorder, udf
from .applyroute import APPLY_GRAN

# Finite reduce identities (f32 extremes, not ±inf), as in the reference.
REDUCE_IDENTITY = {
    "sum": 0.0,
    "min": float(np.finfo(np.float32).max),
    "max": float(np.finfo(np.float32).min),
}
_SCATTER = {"min": "amin", "max": "amax"}
# mirror rows that share one exponent of a narrow-resident scale plane
SCALE_GROUP = 32


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as f32, built from its exponent bits: exact for every integer e
    in [-126, 127] (a libm exp2 need not be)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def dequant_rows(x: torch.Tensor, xscale: torch.Tensor | None,
                 nl: int) -> torch.Tensor:
    """The f32 rows a triplet kernel reads from x [nl * V, Dx] (f32, bf16,
    int8, int16 or fp8): the exact upcast, times 2^xscale when a scale plane
    xscale [nl * ceil(V / SCALE_GROUP), Dx] int8 is given, row v of
    partition q taking exponent row q * ceil(V / SCALE_GROUP) + v //
    SCALE_GROUP."""
    xf = x.float()
    if xscale is None:
        return xf
    v = x.shape[0] // max(nl, 1)
    nb = -(-v // SCALE_GROUP)
    e = xscale.reshape(nl, nb, -1).repeat_interleave(SCALE_GROUP, dim=1)
    return xf * pow2(e[:, :v].reshape(x.shape[0], -1))


def csr_segments(live: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Flat segment id (q * V + v) of every entry of a [nl, E] slab whose
    partition-q row pointers ptr [nl, V+1] place it in segment v; entries
    that are dead or past ptr[q, V] get nl * V."""
    nl, e_blk = live.shape
    v = ptr.shape[1] - 1
    pos = torch.arange(e_blk, dtype=ptr.dtype, device=ptr.device)
    seg = torch.searchsorted(ptr.contiguous(), pos.expand(nl, e_blk)
                             .contiguous(), right=True).long() - 1
    seg = seg + torch.arange(nl, device=ptr.device)[:, None] * v
    keep = live & (pos[None, :] < ptr[:, -1:])
    return torch.where(keep, seg, nl * v)


def segment_sum(msgs: torch.Tensor, live: torch.Tensor,
                ptr: torch.Tensor) -> torch.Tensor:
    """Sum the live entries of messages [nl, E, ...], which lie in the
    aggregation side's CSR order, into segments [nl, V, ...] delimited by
    the row pointers ptr [nl, V+1].  f32 accumulation, result in the
    message dtype."""
    nl, e_blk = live.shape
    v = ptr.shape[1] - 1
    ids = csr_segments(live, ptr).reshape(-1)
    keep = ids < nl * v
    m = msgs.reshape(nl * e_blk, -1)[keep].float()
    out = torch.zeros((nl * v, m.shape[1]), dtype=torch.float32,
                      device=msgs.device)
    out.index_add_(0, ids[keep], m)
    return out.reshape((nl, v) + tuple(msgs.shape[2:])).to(msgs.dtype)


def _csr_edges(ptr, perm, e_blk: int) -> torch.Tensor:
    """Flat edge indices of every partition's live edges in CSR order."""
    nl = ptr.shape[0]
    order = (torch.arange(e_blk, device=ptr.device).expand(nl, e_blk)
             if perm is None else perm.long())
    keep = torch.arange(e_blk, device=ptr.device)[None, :] < ptr[:, -1:].long()
    base = torch.arange(nl, device=ptr.device)[:, None] * e_blk
    return (order + base)[keep]


def triplet_messages(x, ev, src_slot, dst_slot, live, ptr, perm, spec, *,
                     to: str = "dst", xscale=None):
    """The messages `fused_triplet` reduces: (agg [n] flat slot of each live
    edge in CSR order, msgs [n, dm] f32).  Arguments as `fused_triplet`."""
    nl, e_blk = src_slot.shape
    x = dequant_rows(x, xscale, nl)
    s = x.shape[0]
    v_mir = s // max(nl, 1)
    e = _csr_edges(ptr, perm, e_blk)
    e = e[live.reshape(-1)[e]]
    off = (e // e_blk) * v_mir
    rows = {"xs": src_slot.reshape(-1)[e].long() + off,
            "xd": dst_slot.reshape(-1)[e].long() + off}

    def load(arr, col, dt):
        col_t = ev[e, col] if arr == "ev" else x[rows[arr], col]
        return col_t.to(dt)

    msgs = torch.stack([m.to(torch.float32).expand(e.shape[0])
                        for m in udf.evaluate(spec.ir, load, x.device)], 1)
    agg = (src_slot if to == "src" else dst_slot).reshape(-1)[e].long() + off
    return agg, msgs


def fused_triplet(x, ev, src_slot, dst_slot, live, ptr, perm, spec, *,
                  to: str = "dst", reduce: str = "sum", xscale=None):
    """out[v] = reduce over live edges e with slot_to(e) = v of
    UDF(x[src e], ev[e], x[dst e]); returns (out [S, dm] f32 with the
    reduce identity at empty slots, cnt [S] f32 live message counts).

    x [S, Dx] packed mirror rows (S = nl * v_mir): f32, bf16, or a
    narrow-resident payload (int8, int16, fp8) with its scale plane xscale
    (see `dequant_rows`), read as the exact f32 values; ev [nl*E_blk, De]
    f32 packed edge payload, src_slot/dst_slot/live [nl, E_blk], ptr
    [nl, v_mir+1] CSR row pointers of the aggregation side, perm
    [nl, E_blk] its edge order (to="src"; None for "dst"), spec a
    kernels.triplet.TripletUdf."""
    s = x.shape[0]
    agg, msgs = triplet_messages(x, ev, src_slot, dst_slot, live, ptr, perm,
                                 spec, to=to, xscale=xscale)
    cnt = torch.zeros(s, dtype=torch.float32, device=x.device)
    cnt.index_add_(0, agg, torch.ones_like(agg, dtype=torch.float32))
    if reduce == "sum":
        out = torch.zeros((s, spec.dm), dtype=torch.float32, device=x.device)
        out.index_add_(0, agg, msgs)
    else:
        out = torch.full((s, spec.dm), REDUCE_IDENTITY[reduce],
                         dtype=torch.float32, device=x.device)
        out.scatter_reduce_(0, agg[:, None].expand_as(msgs), msgs,
                            _SCATTER[reduce], include_self=True)
    return out, cnt


def triplet_terms(x, ev, src_slot, dst_slot, live, ptr, perm, spec,
                  xscale=None):
    """The terms the triplet kernel reduces, at their CSR positions: (terms
    [nl, E_blk, dm] f32, zero where dead, live [nl, E_blk] bool of each
    position, false past ptr[:, -1]).  Arguments as `fused_triplet`."""
    nl, e_blk = src_slot.shape
    pos = torch.arange(e_blk, device=ptr.device)
    order = pos.expand(nl, e_blk) if perm is None else perm.long()
    e = order + torch.arange(nl, device=ptr.device)[:, None] * e_blk
    lv = live.reshape(-1)[e] & (pos[None, :] < ptr[:, -1:].long())
    _, msgs = triplet_messages(x, ev, src_slot, dst_slot, live, ptr, perm,
                               spec, xscale=xscale)
    terms = torch.zeros((nl, e_blk, spec.dm), dtype=torch.float32,
                        device=x.device)
    terms[lv] = msgs
    return terms, lv


def ordered_segment_reduce(terms, live, ptr, pieces, reduce: str = "sum"):
    """The summation order of `csrc/segorder.cuh`, in plain PyTorch.

    terms [nl, E, D] (f32) and live [nl, E] at CSR positions, ptr
    [nl, V+1] row pointers, pieces their `segorder.Pieces` (host or
    device).  Each piece's live terms are combined step by step in
    ascending position from the identity (`torch.where(live, acc + t,
    acc)`), then each segment's piece partials step by step in piece
    order.  Elementwise ops only, no float sum whose order torch leaves
    open.  Pieces are binned by length, so a step touches only the
    pieces still running.  Returns (out [nl * V, D] f32, identity where no
    term is live; cnt [nl * V] int64 live terms)."""
    nl, e_blk = live.shape
    dev = terms.device
    t = terms.reshape(nl * e_blk, -1).float()
    lv = live.reshape(-1).to(dev)
    ident = REDUCE_IDENTITY[reduce]
    op = {"sum": torch.add, "min": torch.minimum,
          "max": torch.maximum}[reduce]
    host = segorder.Pieces(*(np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                        else a) for a in pieces))
    q, _, begin, end = segorder.spans(np.asarray(ptr.cpu()), host)
    # within each piece: position i of every piece longer than i
    length = end - begin
    by_len = np.argsort(-length, kind="stable")
    longer = np.cumsum(np.bincount(length, minlength=segorder.SEG_PIECE + 1)
                       [::-1])[::-1]                    # longer[i]: len >= i
    base = torch.as_tensor(q * e_blk + begin, device=dev)
    by_len = torch.as_tensor(by_len, device=dev)
    acc = torch.full((length.size, t.shape[1]), ident, dtype=torch.float32,
                     device=dev)
    cnt = torch.zeros(length.size, dtype=torch.int64, device=dev)
    for i in range(segorder.SEG_PIECE):
        run = by_len[:int(longer[i + 1])]
        p = base[run] + i
        keep = lv[p]
        acc[run] = torch.where(keep[:, None], op(acc[run], t[p]), acc[run])
        cnt[run] += keep
    # then over each segment's pieces; pieces are listed per partition in
    # table order, so piece k of partition q is row first[q] + k
    pptr = host.ptr.astype(np.int64)
    first = np.cumsum(pptr[:, -1]) - pptr[:, -1]
    k0 = (first[:, None] + pptr[:, :-1]).reshape(-1)
    n = np.diff(pptr, axis=1).reshape(-1)
    by_n = np.argsort(-n, kind="stable")
    more = np.cumsum(np.bincount(n, minlength=2)[::-1])[::-1]  # n >= j
    k0_t = torch.as_tensor(k0, device=dev)
    out, total = acc[k0_t].clone(), cnt[k0_t].clone()
    for j in range(1, len(more) - 1):
        segs = torch.as_tensor(by_n[:int(more[j + 1])], device=dev)
        k = k0_t[segs] + j
        out[segs] = op(out[segs], acc[k])
        total[segs] += cnt[k]
    return out, total


def ordered_triplet(x, ev, src_slot, dst_slot, live, ptr, perm, spec, pieces,
                    *, reduce: str = "sum", xscale=None):
    """The triplet kernel's exact result (`ordered_segment_reduce` over
    `triplet_terms`): (out [S, dm] f32, cnt [S] f32)."""
    terms, lv = triplet_terms(x, ev, src_slot, dst_slot, live, ptr, perm,
                              spec, xscale)
    out, cnt = ordered_segment_reduce(terms, lv, ptr, pieces, reduce)
    return out, cnt.to(torch.float32)


def sum_tol(agg, msgs, n_slots: int):
    """Per-slot limit [n_slots, D] (float64) on |a - b| for two f32 sums of
    the same messages (msgs [n, D] into flat slots agg [n]) in different
    orders.  A sum of n terms in any order is within gamma_(n-1) * sum|m|
    of the exact sum, gamma_k = k u / (1 - k u) (Higham, Accuracy and
    Stability, 4.2), so two such sums differ by at most twice that.  A slot
    of one message gets 0; a dropped or doubled message of an ordinary slot
    exceeds the limit."""
    u = 2.0 ** -24
    absum = torch.zeros((n_slots, msgs.shape[1]), dtype=torch.float64,
                        device=msgs.device)
    absum.index_add_(0, agg, msgs.abs().double())
    k = (torch.bincount(agg, minlength=n_slots).double() - 1).clamp(min=0)
    gamma = k * u / (1 - k * u)
    return 2 * gamma[:, None] * absum


def fused_apply(msgs, rflags, send, rng, xs, vid, vmask, spec, *,
                reduce: str = "sum"):
    """Combine + vprog + changed at the vertex homes.

    msgs: the routed message leaves [nl, P, K, ...] in their own dtypes;
    rflags [nl, P, K] bool; send [nl, P, K] int32, the route's home slot of
    each entry; rng [nl, P, NB+1] int32, its apply_rng
    (`kernels/applyroute.py`); xs: the vertex leaves [nl, V_blk, ...];
    vid [nl, V_blk] int32; vmask [nl, V_blk] bool; spec a
    kernels.superstep.ApplyUdf.  An entry j of route row (q, pe) counts
    where its flag is set and the granule range of rng that holds j is its
    home slot's granule; each slot combines its entries in ascending source
    partition (sums in f32).  Returns (new leaves, changed [nl, V_blk]
    bool): a leaf the vprog passes through is the old tensor itself, a
    written one a new tensor of its dtype whose invisible rows keep their
    old bits."""
    nl, p, k = send.shape
    v_blk = vid.shape[1]
    dev = vid.device
    pay = torch.cat([m.reshape(nl, p, k, -1).float() for m in msgs], -1)
    acc = torch.full((nl, v_blk + 1, pay.shape[-1]), REDUCE_IDENTITY[reduce],
                     dtype=torch.float32, device=dev)
    hit = torch.zeros((nl, v_blk + 1), dtype=torch.bool, device=dev)
    rows = torch.arange(nl, device=dev)[:, None]
    j = torch.arange(k, dtype=rng.dtype, device=dev).expand(nl, k).contiguous()
    for pe in range(p):
        slot = send[:, pe].long()
        gran = torch.searchsorted(rng[:, pe, 1:].contiguous(), j, right=True)
        ok = rflags[:, pe] & (slot >= 0) & (gran == slot // APPLY_GRAN)
        slot = torch.where(ok, slot, v_blk)   # the spare column swallows
        cur, row = acc[rows, slot], pay[:, pe]
        if reduce == "sum":
            red = cur + row
        else:
            red = (torch.minimum if reduce == "min" else torch.maximum)(cur, row)
        acc[rows, slot] = torch.where(ok[..., None], red, cur)
        hit[rows, slot] = hit[rows, slot] | ok
    return apply_home(spec, acc[:, :v_blk].reshape(nl * v_blk, -1),
                      hit[:, :v_blk].reshape(-1), xs, vid, vmask)


def apply_home(spec, acc, exists, xs, vid, vmask):
    """The apply half after the combine: default substitution in each
    message leaf's dtype, vprog on the f32-staged state, changed bit,
    invisible rows kept, passed-through leaves returned as they are."""
    nl, v_blk = vid.shape
    n = nl * v_blk
    msgs = []
    for l, (dt, dflt) in enumerate(zip(spec.msg_dtypes, spec.defaults)):
        tdt = udf.TORCH_DTYPE[dt]
        m = torch.where(exists, acc[:, l], 0.0).to(tdt)
        msgs.append(torch.where(exists, m, torch.tensor(dflt, dtype=tdt,
                                                       device=vid.device)))
    x = torch.cat([leaf.reshape(n, -1).float() for leaf in xs], 1)

    def load_vp(arr, col, dt):
        return {"vid": lambda: vid.reshape(-1), "x": lambda: x[:, col],
                "m": lambda: msgs[col]}[arr]().to(dt)

    new = torch.stack([o.to(torch.float32).expand(n) for o in udf.evaluate(
        spec.vprog, load_vp, vid.device)], 1)
    vm = vmask.reshape(-1)
    if spec.changed is None:
        chg = (new != x).any(dim=1)
    else:
        def load_ch(arr, col, dt):
            return (x if arr == "x" else new)[:, col].to(dt)
        (chg,) = udf.evaluate(spec.changed, load_ch, vid.device)
        chg = chg.expand(n)
    out, col = [], 0
    for leaf, written in zip(xs, spec.written):
        w = math.prod(leaf.shape[2:])
        if written:
            val = new[:, col:col + w].to(leaf.dtype).reshape(leaf.shape)
            keep = vmask.reshape(vmask.shape + (1,) * (leaf.dim() - 2))
            leaf = torch.where(keep, val, leaf)
        out.append(leaf)
        col += w
    return out, (chg & vm).reshape(nl, v_blk)


# The Pallas flash kernel's finite mask value (-0.7 * f32 max).
NEG_BIG = -0.7 * float(np.finfo(np.float32).max)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    kv_offset: int = 0) -> torch.Tensor:
    """GQA attention with the Pallas kernel's semantics
    (`repro/kernels/flash_attention.py`): q [B, Hq, Lq, Dh], k/v
    [B, Hkv, Lk, Dh]; query head h reads KV head h // (Hq // Hkv); query
    position i sees keys <= i + kv_offset when causal.  The softmax is f32:
    q is scaled before the dot product, masked logits take NEG_BIG, p is 0
    on masked keys, and a row with every key masked returns 0 (where a
    plain softmax gives NaN).  Output in q's dtype."""
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {hkv}")
    g = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, hkv, g, lq, dh) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    if causal:
        rows = torch.arange(lq, device=q.device)[:, None] + kv_offset
        mask = rows >= torch.arange(lk, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_BIG)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    else:
        p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, hq, lq, dh).to(q.dtype)


def flash_partial(q, k, v, lo: int, hi: int, *, causal: bool = True,
                  scale: float | None = None, kv_offset: int = 0):
    """The softmax state of every query row over the keys [lo, hi) alone,
    f32: (m [B, Hq, Lq], l [B, Hq, Lq], acc [B, Hq, Lq, Dh]).  m is NEG_BIG
    and l, acc are 0 where every key of the range is masked (or the range
    is empty)."""
    b, hq, lq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, hkv, g, lq, dh) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k[:, :, lo:hi].float())
    mask = torch.ones((lq, hi - lo), dtype=torch.bool, device=q.device)
    if causal:
        mask = (torch.arange(lq, device=q.device)[:, None] + kv_offset
                >= torch.arange(lo, hi, device=q.device)[None, :])
    s = torch.where(mask, s, NEG_BIG)
    m = s.amax(-1) if hi > lo else torch.full(s.shape[:-1], NEG_BIG,
                                              device=q.device)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v[:, :, lo:hi].float())
    return (m.reshape(b, hq, lq), p.sum(-1).reshape(b, hq, lq),
            acc.reshape(b, hq, lq, dh))


def flash_split_merge(q, k, v, splits, *, causal: bool = True,
                      scale: float | None = None,
                      kv_offset: int = 0) -> torch.Tensor:
    """The split-KV model of the flash kernel: one `flash_partial` per key
    range of `splits` (the kernel's plan), merged in split order 0..n-1 as
    the last CTA of a row tile merges them:
    M = max m_s, L = sum l_s exp(m_s - M), O = sum acc_s exp(m_s - M),
    out = O / L, and 0 where L is 0.  Output in q's dtype."""
    parts = [flash_partial(q, k, v, lo, hi, causal=causal, scale=scale,
                           kv_offset=kv_offset) for lo, hi in splits]
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    lsum = torch.zeros_like(mx)
    out = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp(m - mx)
        lsum = lsum + l * f
        out = out + acc * f[..., None]
    out = out / torch.where(lsum == 0.0, 1.0, lsum)[..., None]
    return out.to(q.dtype)


def mlstm_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logi: torch.Tensor, logf: torch.Tensor, *, chunk: int = 128):
    """The chunkwise mLSTM scan of `repro/kernels/ref.py:mlstm_chunked`,
    op for op in f32, split before its last division: (num [B, H, L, Dh],
    den [B, H, L], m_row [B, H, L]), with out = num / max(|den|,
    exp(-m_row)).  q/k/v [B, H, L, Dh] (q pre-scaled), logi/logf
    [B, H, L]; L % min(chunk, L) == 0."""
    b, h, l, dh = q.shape
    w = min(chunk, l)
    assert l % w == 0, (l, w)
    nc = l // w

    def chunks(x):
        return x.float().reshape(b, h, nc, w, *x.shape[3:]).movedim(2, 0)

    cq, ck, cv, cli, clf = map(chunks, (q, k, v, logi, logf))
    tri = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    C = q.new_zeros((b, h, dh, dh), dtype=torch.float32)
    n = q.new_zeros((b, h, dh), dtype=torch.float32)
    nums, dens, ms = [], [], []
    for qc, kc, vc, lic, lfc in zip(cq, ck, cv, cli, clf):
        cum = torch.cumsum(lfc, dim=-1)
        total = cum[..., -1:]
        dmat = cum[..., :, None] - cum[..., None, :] + lic[..., None, :]
        dmat = torch.where(tri, dmat, float("-inf"))
        m_row = torch.maximum(dmat.amax(-1), cum)
        att = torch.einsum("bhtk,bhsk->bhts", qc, kc) * torch.exp(
            dmat - m_row[..., None])
        intra = torch.einsum("bhts,bhsk->bhtk", att, vc)
        dec = torch.exp(cum - m_row)
        inter = torch.einsum("bhtk,bhkv->bhtv", qc * dec[..., None], C)
        nums.append(intra + inter)
        dens.append(att.sum(-1) + torch.einsum("bhtk,bhk->bht",
                                               qc * dec[..., None], n))
        ms.append(m_row)
        wgt = torch.exp(total - cum + lic)
        C = torch.exp(total)[..., None] * C + torch.einsum(
            "bhsk,bhsv->bhkv", kc * wgt[..., None], vc)
        n = torch.exp(total) * n + torch.einsum("bhsk,bhs->bhk", kc, wgt)
    return (torch.cat(nums, 2), torch.cat(dens, 2), torch.cat(ms, 2))


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logi: torch.Tensor, logf: torch.Tensor, *,
                  chunk: int = 128) -> torch.Tensor:
    """Chunkwise mLSTM, out [B, H, L, Dh] f32 (`mlstm_parts`).  Its
    gradient is torch autograd through these ops."""
    num, den, m_row = mlstm_parts(q, k, v, logi, logf, chunk=chunk)
    return num / torch.maximum(den.abs(), torch.exp(-m_row))[..., None]


def _mlstm_chunks(w: int, *xs):
    """[B, H, L, ...] -> [B, H, NC, W, ...] in f32, for each of xs."""
    return [x.float().reshape(*x.shape[:2], x.shape[2] // w, w,
                              *x.shape[3:]) for x in xs]


def _mlstm_gates(cli, clf):
    """Per chunk: cum, total [.., 1], the masked exponent dmat - m as P's
    log (P = 0 above the diagonal), m, dec, wgt."""
    w = cli.shape[-1]
    tri = torch.ones((w, w), dtype=torch.bool, device=cli.device).tril()
    cum = torch.cumsum(clf, -1)
    total = cum[..., -1:]
    dmat = cum[..., :, None] - cum[..., None, :] + cli[..., None, :]
    dmat = torch.where(tri, dmat, float("-inf"))
    m = torch.maximum(dmat.amax(-1), cum)
    return (cum, total, torch.exp(dmat - m[..., None]), m,
            torch.exp(cum - m), torch.exp(total - cum + cli))


def mlstm_chunk_states(k: torch.Tensor, v: torch.Tensor, logi: torch.Tensor,
                       logf: torch.Tensor, *, chunk: int = 128):
    """The chunk-state scan of the split chunkwise mLSTM: each chunk's
    entry state (C [B, H, NC, Dh, Dh], n [B, H, NC, Dh]; chunk 0's is 0),
    by C <- e^total C + (k wgt)^T v and n <- e^total n + sum_s k_s wgt_s."""
    w = min(chunk, k.shape[2])
    ck, cv, cli, clf = _mlstm_chunks(w, k, v, logi, logf)
    _, total, _, _, _, wgt = _mlstm_gates(cli, clf)
    b, h, nc, _, dh = ck.shape
    C = k.new_zeros((b, h, dh, dh), dtype=torch.float32)
    n = k.new_zeros((b, h, dh), dtype=torch.float32)
    cs, ns = [], []
    for c in range(nc):
        cs.append(C)
        ns.append(n)
        kw = ck[:, :, c] * wgt[:, :, c, :, None]
        e = torch.exp(total[:, :, c])
        C = e[..., None] * C + kw.transpose(-1, -2) @ cv[:, :, c]
        n = e * n + kw.sum(-2)
    return torch.stack(cs, 2), torch.stack(ns, 2)


def mlstm_chunk_out(q, k, v, logi, logf, C, n, *, chunk: int = 128):
    """The chunk-parallel half of the split: every chunk's output from its
    entry state (`mlstm_chunk_states`), all chunks at once.  Returns (out
    [B, H, L, Dh], den, m [B, H, L])."""
    b, h, l, dh = q.shape
    w = min(chunk, l)
    cq, ck, cv, cli, clf = _mlstm_chunks(w, q, k, v, logi, logf)
    _, _, P, m, dec, _ = _mlstm_gates(cli, clf)
    att = (cq @ ck.transpose(-1, -2)) * P
    qd = cq * dec[..., None]
    num = att @ cv + qd @ C
    den = att.sum(-1) + (qd @ n[..., None])[..., 0]
    out = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]
    return (out.reshape(b, h, l, dh), den.reshape(b, h, l),
            m.reshape(b, h, l))


def mlstm_dstate_scan(q, logi, logf, out, dout, den, m, *, chunk: int = 128):
    """The reverse scan of the split's backward: with g = max(|den|,
    e^-m), dnum = dout / g and dden = -[|den| >= e^-m] sign(den)
    (dout . out) / g per row (m held constant), the cotangents of the
    state leaving each chunk, dC [B, H, NC, Dh, Dh] and dn [B, H, NC, Dh]
    (the last chunk's 0), by dC <- e^total dC + (dec q)^T dnum and
    dn <- e^total dn + (dec q)^T dden.  Returns (dC, dn, g, dden)."""
    w = min(chunk, q.shape[2])
    cq, cli, clf, co, cdo = _mlstm_chunks(w, q, logi, logf, out, dout)
    cden, cm = _mlstm_chunks(w, den, m)
    _, total, _, _, _, _ = _mlstm_gates(cli, clf)
    dec = torch.exp(torch.cumsum(clf, -1) - cm)
    em = torch.exp(-cm)
    g = torch.maximum(cden.abs(), em)
    dden = torch.where(cden.abs() >= em,
                       -torch.sign(cden) * (cdo * co).sum(-1) / g, 0.0)
    qd = cq * dec[..., None]
    dnum = cdo / g[..., None]
    b, h, nc, _, dh = cq.shape
    X = q.new_zeros((b, h, dh, dh), dtype=torch.float32)
    xn = q.new_zeros((b, h, dh), dtype=torch.float32)
    dcs, dns = [], []
    for c in reversed(range(nc)):
        dcs.append(X)
        dns.append(xn)
        e = torch.exp(total[:, :, c])
        X = e[..., None] * X + qd[:, :, c].transpose(-1, -2) @ dnum[:, :, c]
        xn = e * xn + (qd[:, :, c] * dden[:, :, c, :, None]).sum(-2)
    return (torch.stack(dcs[::-1], 2), torch.stack(dns[::-1], 2),
            g.reshape(den.shape), dden.reshape(den.shape))


def mlstm_chunk_grads(q, k, v, logi, logf, dout, C, n, dC, dn, g, dden, *,
                      chunk: int = 128):
    """The chunk-parallel half of the split's backward: per chunk, from
    its entry state C, n, the cotangents dC, dn of the state leaving it,
    and g, dden (`mlstm_dstate_scan`), (dq, dk, dv [B, H, L, Dh], dlogi,
    dlogf [B, H, L]) -- the formulas of csrc/mlstm_tc.cu:mlstm_bwd_chunk."""
    b, h, l, dh = q.shape
    w = min(chunk, l)
    cq, ck, cv, cdo, cli, clf = _mlstm_chunks(w, q, k, v, dout, logi, logf)
    cg, cdd = _mlstm_chunks(w, g, dden)
    _, total, P, _, dec, wgt = _mlstm_gates(cli, clf)
    tri = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    dnum = cdo / cg[..., None]
    att = (cq @ ck.transpose(-1, -2)) * P
    datt = torch.where(tri, dnum @ cv.transpose(-1, -2) + cdd[..., None],
                       0.0)
    dS, ddm = datt * P, datt * att
    E = dnum @ C.transpose(-1, -2)
    qn = (cq @ n[..., None])[..., 0]
    ddec = (cq * E).sum(-1) + cdd * qn
    dq = dec[..., None] * E + (dec * cdd)[..., None] * n[..., None, :] \
        + dS @ ck
    F = cv @ dC.transpose(-1, -2) + dn[..., None, :]
    dwgt = (ck * F).sum(-1)
    dk = wgt[..., None] * F + dS.transpose(-1, -2) @ cq
    dv = wgt[..., None] * (ck @ dC) + att.transpose(-1, -2) @ dnum
    dw = dwgt * wgt
    coldd, rowdd = ddm.sum(-2), ddm.sum(-1)
    dlogi = coldd + dw
    dcum = (rowdd - coldd) + ddec * dec - dw
    de = (dC * C).sum((-1, -2)) + (dn * n).sum(-1)
    dtotal = dw.sum(-1) + de * torch.exp(total[..., 0])
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + dtotal[..., None]], -1)
    dlogf = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    return (dq.reshape(b, h, l, dh), dk.reshape(b, h, l, dh),
            dv.reshape(b, h, l, dh), dlogi.reshape(b, h, l),
            dlogf.reshape(b, h, l))


def mlstm_split(q, k, v, logi, logf, *, chunk: int = 128):
    """The split chunkwise mLSTM forward (`mlstm_chunk_states`, then
    `mlstm_chunk_out`): out [B, H, L, Dh] f32, the function of
    `mlstm_chunked`."""
    C, n = mlstm_chunk_states(k, v, logi, logf, chunk=chunk)
    return mlstm_chunk_out(q, k, v, logi, logf, C, n, chunk=chunk)[0]


def mlstm_split_backward(q, k, v, logi, logf, dout, *, chunk: int = 128):
    """The split's gradient of <out, dout> with m held constant: the state
    scan, the chunk outputs, the reverse dC scan, then the chunk-parallel
    gradients.  Returns (dq, dk, dv, dlogi, dlogf)."""
    C, n = mlstm_chunk_states(k, v, logi, logf, chunk=chunk)
    out, den, m = mlstm_chunk_out(q, k, v, logi, logf, C, n, chunk=chunk)
    dC, dn, g, dden = mlstm_dstate_scan(q, logi, logf, out, dout, den, m,
                                        chunk=chunk)
    return mlstm_chunk_grads(q, k, v, logi, logf, dout, C, n, dC, dn, g,
                             dden, chunk=chunk)


def fused_gather_segment_sum(x: torch.Tensor, w: torch.Tensor,
                             src_slot: torch.Tensor, dst_slot: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """SpMV: out[v] = sum over edges e with dst(e) = v of w[e] * x[src e]
    (f32 [num_segments, D]); edges with dst >= num_segments drop."""
    keep = dst_slot < num_segments
    msgs = x[src_slot[keep].long()].float() * w[keep, None].float()
    out = torch.zeros((num_segments, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, dst_slot[keep].long(), msgs)
