"""The flash attention backward on the CPU: the plain backward against the
reference's gradient, the plain log-sum-exp the backward kernel reads, the
backward kernel's plan, and the forward's plan at head dimensions to 256.

The reference has no backward kernel: off the TPU it differentiates
`repro.kernels.ref.flash_attention`, so `kernels.ref.
flash_attention_backward` is held to `jax.grad` of that function on the
same seeded numpy inputs (f32 on both sides, sums in other orders: 2e-5
relative norm per gradient, about 100 f32 roundings), and to autograd of
the port's plain forward (1e-5).  A row whose keys are all masked has no
reference gradient (the reference's softmax over -inf gives NaN there); the
port gives it zero, and autograd of its own plain forward agrees.

`ref.flash_lse` (the forward kernel's log-sum-exp, which the backward
kernel reads in place of a pass of its own) is held to the reference: P =
exp2(s scale log2(e) - lse) from it, times V, is the reference's output
(f32, 2e-5 relative norm, on the rows that see a key: the reference's
softmax gives NaN on the others), each live row of P sums to 1 (1e-5),
and rows that see no key are +inf.

`bwd_plan` is the model of csrc/flash_attention_bwd.cu's walks: hypothesis
checks that the dQ walk and the dK/dV walk each visit every visible
(query, key) pair exactly once and no tile wholly above the shifted
diagonal, and that both kernels fit 227 KB of shared memory.  The kernel
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BF16, F32 = torch.bfloat16, torch.float32

# (B, Hq, Hkv, Lq, Lk, Dh, causal, kv_offset): groups 1, 2 and 10, Dh 16 to
# 256, causal and not, kv_offset > 0 (the windowed call's shape, small)
CASES = [
    (2, 2, 2, 24, 24, 16, True, 0),
    (1, 4, 2, 17, 40, 32, True, 23),
    (1, 10, 1, 16, 32, 256, True, 16),
    (2, 4, 2, 9, 13, 64, False, 0),
    (1, 8, 4, 33, 50, 128, False, 0),
    (1, 10, 1, 12, 12, 48, True, 0),
    (1, 2, 1, 20, 45, 96, True, 25),
    (1, 6, 3, 31, 7, 16, True, 3),
]


def _inputs(b, hq, hkv, lq, lk, dh, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((b, hq, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh)))
    dout = rng.normal(size=(b, hq, lq, dh)).astype(np.float32)
    return q, k, v, dout


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad_of_the_reference(case):
    b, hq, hkv, lq, lk, dh, causal, off = case
    q, k, v, dout = _inputs(b, hq, hkv, lq, lk, dh)
    t = [torch.from_numpy(x) for x in (q, k, v, dout)]
    out = ref.flash_attention(*t[:3], causal=causal, kv_offset=off)
    got = ref.flash_attention_backward(*t[:3], out, t[3], causal=causal,
                                       kv_offset=off)
    jout, vjp = jax.vjp(lambda *a: jref.flash_attention(
        *a, causal=causal, kv_offset=off), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == F32 and g.shape == w.shape
        assert _rel(g.numpy(), w) <= 2e-5, name


@pytest.mark.parametrize("case", CASES + [(1, 2, 1, 10, 10, 16, True, -3),
                                          (1, 4, 4, 8, 5, 32, True, -6)])
def test_plain_backward_matches_autograd_of_the_plain_forward(case):
    """Also with dead rows (kv_offset < 0: the first rows see no key),
    whose gradient is zero."""
    b, hq, hkv, lq, lk, dh, causal, off = case
    q, k, v, dout = (torch.from_numpy(x) for x in
                     _inputs(b, hq, hkv, lq, lk, dh, seed=1))
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ref.flash_attention(*ins, causal=causal, kv_offset=off)
    want = torch.autograd.grad(out, ins, dout)
    got = ref.flash_attention_backward(q, k, v, out.detach(), dout,
                                       causal=causal, kv_offset=off)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g.numpy(), w.numpy()) <= 1e-5
    if off < 0:
        dead = -off
        assert not bool(got[0][:, :, :dead].any())


@pytest.mark.parametrize("case", CASES + [(1, 2, 1, 10, 10, 16, True, -3),
                                          (1, 10, 1, 16, 32, 256, True, -5)])
def test_plain_lse_matches_the_reference(case):
    """P from the plain log-sum-exp reproduces the reference's attention;
    its live rows sum to 1, its dead rows (kv_offset < 0) are +inf."""
    b, hq, hkv, lq, lk, dh, causal, off = case
    q, k, v, _ = _inputs(b, hq, hkv, lq, lk, dh, seed=3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    lse = ref.flash_lse(tq, tk, causal=causal, kv_offset=off)
    assert lse.dtype == F32 and lse.shape == (b, hq, lq)
    g = hq // hkv
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     tq.double().reshape(b, hkv, g, lq, dh), tk.double())
    s2 = s * dh ** -0.5 / np.log(2.0)
    vis = torch.from_numpy(_visible(lq, lk, causal, off))
    p = torch.where(vis, torch.exp2(
        s2 - lse.double().reshape(b, hkv, g, lq)[..., None]), 0.0)
    dead = ~vis.any(-1)
    assert bool(torch.isinf(lse).reshape(b, hkv, g, lq)[..., dead].all())
    assert bool((lse.reshape(b, hkv, g, lq)[..., dead] > 0).all())
    assert not bool(torch.isinf(lse).reshape(b, hkv, g, lq)[..., ~dead].any())
    rows = p.sum(-1)[..., ~dead]
    np.testing.assert_allclose(rows.numpy(), 1.0, rtol=0, atol=1e-5)
    got = torch.einsum("bhgqk,bhkd->bhgqd", p, tv.double()).reshape(
        b, hq, lq, dh)
    want = np.asarray(jref.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, kv_offset=off))
    # the reference's softmax gives NaN on a dead row; P there is 0
    live = ~dead.numpy()
    assert not got[:, :, dead].any()
    assert _rel(got[:, :, live].numpy(), want[:, :, live]) <= 2e-5


def test_ops_flash_attention_is_differentiable_on_the_cpu():
    """kops.flash_attention on CPU tensors is the plain version; autograd
    differentiates it, and flash_attention_bwd on CPU tensors is the plain
    backward.  No launch is counted."""
    q, k, v, dout = (torch.from_numpy(x) for x in
                     _inputs(1, 4, 2, 20, 30, 32, seed=2))
    ins = [x.to(BF16).requires_grad_() for x in (q, k, v)]
    before = ops.launch_counts()
    out = ops.flash_attention(*ins, causal=True, kv_offset=10)
    grads = torch.autograd.grad(out, ins, dout.to(BF16))
    plain = flash_mod.flash_attention_bwd(*(x.detach() for x in ins),
                                          out.detach(), dout.to(BF16),
                                          causal=True, kv_offset=10)
    for g, w in zip(grads, plain):
        assert g.dtype == BF16
        assert _rel(g.float().numpy(), w.float().numpy()) <= 1e-2
    assert ops.launch_counts() == before
    assert "flash_attention_bwd" in before


def _defines():
    src = (ROOT / "src/repro_torch/csrc/flash_attention_bwd.cu").read_text()
    return {m[0]: int(m[1]) for m in
            re.findall(r"^#define (\w+) (\d+)", src, re.M)}


# a float atomic or reduction in CUDA C++ or inline PTX
FLOAT_ATOMIC = re.compile(r"atomic\w*\(\s*(float|double|__nv_bfloat16|half)"
                          r"|\b(atom|red)(\.\w+)*\.(f16|bf16|f32|f64)\b")


def test_plan_constants_are_the_sources():
    """bwd_plan's constants are the source's; neither flash source (nor
    the header both inline) holds a float atomic, and the backward no
    atomic at all."""
    d = _defines()
    assert (d["STAGES"], d["BLK"], d["THREADS"]) == (
        flash_mod.BWD_STAGES, flash_mod.BWD_BLK, flash_mod.BWD_THREADS)
    src = (ROOT / "src/repro_torch/csrc/flash_attention_bwd.cu").read_text()
    assert f"SPLIT = DHP > {flash_mod.BWD_SPLIT_DH};" in src
    assert "XCHG = SPLIT ? 2 * 32 * 128 * 4 : 0" in src
    assert flash_mod.XCHG == 2 * 32 * 128 * 4
    code = re.sub(r"//[^\n]*", "", src)          # the comments say "no
    assert "atom" not in code.lower()             # float atomics"
    assert "no float atomics" in " ".join(src.lower().replace(
        "//", " ").split())
    for name in ("flash_attention_bwd.cu", "flash_attention.cu",
                 "hopper.cuh"):
        text = (ROOT / "src/repro_torch/csrc" / name).read_text()
        assert not FLOAT_ATOMIC.search(text), name
    fwd = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    assert "atom.acq_rel.gpu.global.add.s32" in fwd    # the split counter
    assert FLOAT_ATOMIC.search("atomicAdd(float* p") and \
        FLOAT_ATOMIC.search("red.global.add.f32 [%0]")


@pytest.mark.parametrize("dh", [16, 32, 48, 64, 96, 128, 192, 256])
def test_bwd_plan_fits_shared_memory(dh):
    """Both kernels fit 227 KB at every accepted Dh; above 128 a CTA's two
    warpgroups share 64 rows on column halves, else each owns 64."""
    p = flash_mod.bwd_plan((2, 10, 2048, dh), (2, 1, 4096, dh), causal=True,
                           kv_offset=2048)
    assert max(p.smem_dq, p.smem_dkv) <= flash_mod.SMEM_LIMIT
    assert p.split == (dh > 128)
    assert p.rows == (64 if dh > 128 else 128)
    assert p.grid_dq == (2048 // p.rows, 10, 2)
    assert p.grid_dkv == (4096 // p.rows, 1, 2)
    for d in range(16, 257, 16):      # every accepted head dimension
        q = flash_mod.bwd_plan((1, 4, 100, d), (1, 2, 300, d), causal=False)
        assert max(q.smem_dq, q.smem_dkv) <= flash_mod.SMEM_LIMIT


def _visible(lq, lk, causal, off):
    i = np.arange(lq)[:, None]
    j = np.arange(lk)[None, :]
    return (j <= i + off) if causal else np.ones((lq, lk), bool)


@settings(max_examples=150, deadline=None)
@given(lq=st.integers(1, 300), lk=st.integers(1, 300),
       off=st.integers(-40, 320), causal=st.booleans(),
       dh=st.sampled_from([16, 64, 256]))
def test_bwd_walks_visit_every_visible_pair_once(lq, lk, off, causal, dh):
    p = flash_mod.bwd_plan((1, 2, lq, dh), (1, 1, lk, dh), causal=causal,
                           kv_offset=off)
    vis = _visible(lq, lk, causal, off)
    blk = flash_mod.BWD_BLK
    dq_seen = np.zeros((lq, lk), int)
    for qt in range(p.grid_dq[0]):
        lo, hi = p.dq_keys(qt)
        rows = slice(qt * p.rows, (qt + 1) * p.rows)
        assert lo == 0 and hi % blk == 0
        for k0 in range(lo, hi, blk):
            keys = slice(k0, k0 + blk)
            assert vis[rows, keys].any()     # no tile wholly invisible
            dq_seen[rows, keys] += 1
    assert (dq_seen[vis] == 1).all()
    dkv_seen = np.zeros((lq, lk), int)
    for kt in range(p.grid_dkv[0]):
        lo, hi = p.dkv_queries(kt)
        keys = slice(kt * p.rows, (kt + 1) * p.rows)
        for q0 in range(lo, hi, blk):
            rows = slice(q0, q0 + blk)
            assert vis[rows, keys].any()
            dkv_seen[rows, keys] += 1
    assert (dkv_seen[vis] == 1).all()
    assert p.lq_pad % p.rows == 0 and p.lq_pad >= lq
    assert max(p.smem_dq, p.smem_dkv) <= flash_mod.SMEM_LIMIT


def test_bwd_plan_copies_only_what_the_kernel_cannot_read():
    """The windowed chunk-0 call's strided views are read in place; a Dh
    stride other than 1 or an unaligned row is copied."""
    nc, w, dh = 2, 2048, 256
    qc = torch.zeros((2 * nc, 10, w, dh), dtype=BF16, device="meta")
    k2 = torch.zeros((2 * nc, 1, 2 * w, dh), dtype=BF16, device="meta")
    q0, k0 = qc[::nc], k2[::nc, :, w:]
    shapes = (q0.shape, k0.shape)
    p = flash_mod.bwd_plan(*shapes, causal=True,
                           strides=(q0.stride(), k0.stride(), k0.stride(),
                                    (10 * w * dh, w * dh, dh, 1),
                                    (10 * w * dh, w * dh, dh, 1)))
    assert p.copy == (False,) * 5
    t = torch.zeros((1, 2, 8, 16), dtype=BF16).transpose(2, 3)
    p = flash_mod.bwd_plan((1, 2, 16, 8), (1, 2, 16, 8), causal=True,
                           strides=(t.stride(),) * 5,
                           aligned=(True, True, True, True, False))
    assert p.copy == (True,) * 5


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("dh", range(136, 257, 8))
def test_forward_plan_takes_head_dims_to_256(dh, dtype):
    """Above Dh 128 the forward runs its wide tensor-core body in bf16 at a
    multiple of 16 and more than 16 rows (the windowed call, a prefill),
    and its CUDA-core body otherwise (f32, Dh not a multiple of 16, the
    decode shape), within 227 KB."""
    for qs, ks, off in (((2, 10, 2048, dh), (2, 1, 4096, dh), 2048),
                        ((1, 10, 1, dh), (1, 1, 2048, dh), 2047),
                        ((1, 4, 300, dh), (1, 2, 300, dh), 0)):
        p = flash_mod.plan(qs, ks, dtype, causal=True, kv_offset=off)
        rows = qs[1] // ks[1] * qs[2]
        wide = dtype == BF16 and dh % 16 == 0 and rows > flash_mod.DECODE_ROWS
        assert p.body == ("tensor_core_wide" if wide else "cuda_core")
        assert p.smem <= flash_mod.SMEM_LIMIT
        assert p.rows <= (flash_mod.TC_ROWS if wide else flash_mod.SIMT_ROWS)
        assert p.threads == (flash_mod.WIDE_THREADS if wide
                             else flash_mod.THREADS)
        assert p.splits[-1][1] == p.kv_end


def test_forward_source_builds_mma_bodies_only_to_128():
    """flash_decode builds only to Dh 128 and flash_tc holds one warpgroup
    there (each holds 2 x Dh / 2 f32 a thread); above it flash_tc builds
    with two warpgroups on O's column halves, to 256, with the plan's
    threads, stages and exchange."""
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    assert (f"DECODE_BODY (DH % 16 == 0 && DH <= {flash_mod.TC_MAX_DH})"
            in src)
    assert f"TC_BODY (DH % 16 == 0 && DH <= {flash_mod.MAX_DH})" in src
    assert f"NWG = DH > {flash_mod.TC_MAX_DH} ? 2 : 1;" in src
    tc = src[src.index("#if TC_BODY\n"):src.index("#endif  // TC_BODY\n")]
    dec = src[src.index("#if DECODE_BODY\n"):
              src.index("#endif  // DECODE_BODY\n")]
    assert "flash_tc(const Args" in tc and "flash_decode(const Args" in dec
    assert "TC_THREADS = NWG == 1 ? THREADS : WIDE_THREADS" in tc
    assert "TC_STAGES = NWG == 1 ? STAGES : WIDE_STAGES" in tc
    assert "xchg + (NWG == 2 ? 2 * 32 * 128 : 0)" in tc
    d = {m[0]: int(m[1]) for m in re.findall(r"^#define (\w+) (\d+)", src,
                                              re.M)}
    assert (d["THREADS"], d["STAGES"], d["WIDE_THREADS"],
            d["WIDE_STAGES"]) == (flash_mod.THREADS, flash_mod.STAGES,
                                  flash_mod.WIDE_THREADS,
                                  flash_mod.WIDE_STAGES)
    assert flash_mod.XCHG == 2 * 32 * 128 * 4
