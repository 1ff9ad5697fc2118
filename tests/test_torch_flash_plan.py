"""`kernels/flash_attention.plan` and the split-KV model, on the CPU.

`plan` picks the flash kernel's body, CTA shape, key splits and shared
memory by shape alone.  Its properties: the splits cut the keys any row can
see into disjoint ranges with nothing left out, the causal cut of each
position tile never drops a key one of its rows sees (a hypothesis sweep
over Lq, Lk, kv_offset including negative values, the GQA group, and Dh
to 256), shared memory fits the H100's 227 KB for every accepted dtype and
Dh (8 to 256), the serve step gets at least 2 x 132 CTAs, and the body at
the documented shapes is the documented one.

`ref.flash_split_merge` is the plain model of the CUDA-core body's split
merge: one partial (m, l, acc) per split, merged in split order.  It is
held against the port's `ref.flash_attention` and the Pallas kernel in
interpret mode on `tests/test_torch_flash.py`'s shapes at that file's
tolerances (3e-5 in f32, 3e-2 in bf16), with `plan`'s splits and with
splits of 7 keys; splits in which every key is masked give 0, not NaN.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
SERVE = ((4, 32, 1, 128), (4, 8, 1664, 128))
SHAPES = [
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 8, 1, 100, 100, 64, True, 0),
    (1, 4, 4, 1, 300, 32, True, 299),
    (2, 2, 2, 48, 96, 16, True, 48),
    (1, 2, 1, 64, 64, 32, False, 0),
    (1, 2, 2, 40, 72, 128, False, 0),
]
TOL = {"float32": 3e-5, "bfloat16": 3e-2}


def _plan(b, hq, hkv, lq, lk, dh, dtype=BF16, causal=True, off=0):
    return flash_mod.plan((b, hq, lq, dh), (b, hkv, lk, dh), dtype,
                          causal=causal, kv_offset=off)


def _covered(ranges):
    """End of the prefix [0, end) that disjoint `ranges` cover without a
    gap; raises if two ranges overlap."""
    end = 0
    for lo, hi in sorted(r for r in ranges if r[1] > r[0]):
        assert lo >= end, f"overlapping ranges {ranges}"
        if lo > end:
            break
        end = hi
    return end


def _check_plan(p, lq, lk, causal, off):
    # the splits partition [0, kv_end), and kv_end covers every visible key
    assert p.splits[0][0] == 0 and p.splits[-1][1] == p.kv_end
    assert all(a[1] == b[0] for a, b in zip(p.splits, p.splits[1:]))
    assert all(hi > lo for lo, hi in p.splits) or p.kv_end == 0
    see = [min(lk, i + off + 1) if causal else lk for i in range(lq)]
    assert p.kv_end >= max(0, max(see))
    for pt in range(p.pos_tiles):
        ranges = [p.key_range(pt, s) for s in range(len(p.splits))]
        pos = range(pt * p.positions, min(lq, (pt + 1) * p.positions))
        assert _covered(ranges) >= max(see[i] for i in pos)
    assert p.rows <= (16 if p.body == "cuda_core" else 64)
    assert p.smem <= flash_mod.SMEM_LIMIT
    assert p.threads == (256 if p.body == "tensor_core_wide" else 128)


def test_plan_at_the_documented_shapes():
    serve = flash_mod.plan(*SERVE, BF16, causal=False)
    assert serve.body == "decode" and serve.ctas >= 2 * flash_mod.SMS
    assert (len(serve.splits), serve.split_keys, serve.ctas) == (9, 192, 288)
    prefill = _plan(1, 32, 8, 4096, 4096, 128)
    chunk = _plan(1, 32, 8, 512, 4096, 128, off=3584)
    assert prefill.body == chunk.body == "tensor_core"
    assert prefill.rows == chunk.rows == 64 and len(prefill.splits) == 1
    assert _plan(1, 32, 8, 4096, 4096, 128, F32).body == "cuda_core"
    assert _plan(4, 32, 8, 1, 1664, 128, F32).body == "cuda_core"
    assert _plan(1, 4, 2, 70, 150, 40).body == "cuda_core"
    assert _plan(1, 2, 2, 40, 90, 16).body == "tensor_core"
    assert _plan(1, 4, 4, 1, 300, 32, off=299).body == "decode"
    assert _plan(1, 4, 4, 1, 300, 32, F32, off=299).body == "cuda_core"
    assert _plan(1, 2, 2, 64, 200, 128, causal=False).body == "tensor_core"
    # recurrentgemma-2b's windowed and chunk-0 calls: the wide body, one
    # split, 6 positions x 10 heads a CTA; its decode shape and f32 stay on
    # the CUDA cores
    win = _plan(2, 10, 1, 2048, 4096, 256, off=2048)
    chunk0 = _plan(1, 10, 1, 2048, 2048, 256)
    assert win.body == chunk0.body == "tensor_core_wide"
    assert (win.heads, win.positions, len(win.splits)) == (10, 6, 1)
    assert win.grid == (342, 1, 2) and win.threads == 256
    assert _plan(1, 10, 1, 1, 2048, 256, off=2047).body == "cuda_core"
    assert _plan(2, 10, 1, 2048, 4096, 256, F32, off=2048).body == \
        "cuda_core"
    assert _plan(1, 4, 2, 70, 150, 136).body == "cuda_core"


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("dh", range(8, 257, 8))
def test_plan_shared_memory_fits_every_accepted_head_dim(dh, dtype):
    for lq, group in ((1, 4), (1, 16), (20, 4), (4096, 4), (300, 1),
                      (100, 8), (1, 64), (2, 32)):
        p = _plan(2, 8 * group, 8, lq, 1664, dh, dtype)
        _check_plan(p, lq, 1664, True, 0)


def test_plan_copies_only_what_the_kernel_cannot_read():
    """The einsum's permuted K/V (the cross-attention's) are read in place;
    a tensor whose Dh stride is not 1, or whose rows are not 16-byte
    aligned, is copied."""
    ctx = torch.zeros((4, 1664, 1024), dtype=BF16)
    k = torch.einsum("bld,dhk->bhlk", ctx,
                     torch.zeros((1024, 8, 128), dtype=BF16))
    assert not k.is_contiguous() and k.stride() == (1664 * 1024, 128, 1024, 1)
    q = torch.zeros((4, 32, 1, 128), dtype=BF16)

    def copies(kk):
        return flash_mod.plan(q.shape, kk.shape, BF16, causal=False,
                              strides=(q.stride(), kk.stride(),
                                       kk.stride())).copy

    assert copies(k) == (False, False, False)
    assert copies(k.contiguous()) == (False, False, False)
    dh_strided = torch.zeros((4, 8, 128, 1664), dtype=BF16).transpose(2, 3)
    assert copies(dh_strided) == (False, True, True)
    ragged = torch.zeros((4, 8, 1664, 130), dtype=BF16)[..., 1:129]
    assert copies(ragged) == (False, True, True)


@settings(max_examples=300, deadline=None)
@given(lq=st.integers(1, 300), lk=st.integers(0, 700),
       off=st.integers(-350, 700), group=st.sampled_from([1, 2, 3, 4, 8, 32]),
       dh=st.sampled_from([16, 40, 64, 128, 144, 200, 256]),
       bf16=st.booleans(),
       causal=st.booleans())
def test_plan_never_drops_a_visible_key(lq, lk, off, group, dh, bf16, causal):
    """Every key that some row sees lies in exactly one split, and the
    causal cut of every position tile keeps every key its rows see."""
    p = _plan(1, 2 * group, 2, lq, lk, dh, BF16 if bf16 else F32, causal,
              off)
    _check_plan(p, lq, lk, causal, off)


def _inputs(shape, dtype, seed=0):
    b, hq, hkv, lq, lk, dh = shape[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((b, hq, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_split_merge_matches_plain_and_pallas_interpret(shape, dtype):
    b, hq, hkv, lq, lk, dh, causal, off = shape
    (jq, jk, jv), (q, k, v) = _inputs(shape, dtype)
    kw = dict(causal=causal, kv_offset=off)
    p = flash_mod.plan(q.shape, k.shape, q.dtype, **kw)
    small = tuple((a, min(a + 7, p.kv_end)) for a in range(0, p.kv_end, 7))
    kern = pallas_flash(jq, jk, jv, block_q=32, block_kv=32, interpret=True,
                        **kw)
    want = ref.flash_attention(q, k, v, **kw)
    tol = TOL[dtype]
    for splits in (p.splits, small):
        got = ref.flash_split_merge(q, k, v, splits, **kw)
        assert got.dtype == q.dtype and got.shape == q.shape
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
        np.testing.assert_allclose(_f32(got), _f32(kern), rtol=tol, atol=tol)


def test_split_merge_wholly_masked_splits_give_zero():
    """kv_offset -3: query rows 0-2 see no key, and rows 3-7 see keys
    0..i-3, so with 2-key splits most splits are wholly masked for some
    rows (their m stays NEG_BIG, l and acc 0).  Dead rows give 0, never
    NaN, and the rest match the kernel in interpret mode."""
    shape = (1, 4, 2, 8, 8, 32, True, -3)
    (jq, jk, jv), (q, k, v) = _inputs(shape, "float32", seed=1)
    kw = dict(causal=True, kv_offset=-3)
    for splits in (((0, 2), (2, 4), (4, 6), (6, 8)),
                   flash_mod.plan(q.shape, k.shape, q.dtype, **kw).splits):
        got = ref.flash_split_merge(q, k, v, splits, **kw)
        assert torch.isfinite(got).all() and torch.all(got[:, :, :3] == 0)
        kern = pallas_flash(jq, jk, jv, block_q=8, block_kv=8,
                            interpret=True, **kw)
        np.testing.assert_allclose(_f32(got), _f32(kern), rtol=3e-5,
                                   atol=3e-5)
    m, l, acc = ref.flash_partial(q, k, v, 6, 8, **kw)
    assert torch.all(m[:, :, :9] == ref.NEG_BIG) and torch.all(l == 0)
    assert torch.all(acc == 0)
    # a call that no row can see: one empty split, every output 0
    none = flash_mod.plan(q.shape, k.shape, q.dtype, causal=True,
                          kv_offset=-8)
    assert none.splits == ((0, 0),)
    got = ref.flash_split_merge(q, k, v, none.splits, causal=True,
                                kv_offset=-8)
    assert torch.all(got == 0)
