"""The port's flash attention (plain version) against the reference.

The port's `kernels/ref.flash_attention` keeps the Pallas kernel's
semantics, so it is held against the Pallas kernel run in interpret mode
(the reference's `ops._resolve` sends "auto" to its jnp oracle off the TPU,
so the kernel is called directly with interpret=True) and against the
reference's oracle `ref.flash_attention`, on the shapes of the reference's
own sweep (`tests/test_kernels.py::test_flash_sweep`: GQA, a one-row query
at offset 299, ragged Lk, non-causal, Dh 128).  Tolerances are the sweep's:
3e-5 in f32, 3e-2 in bf16 (the output rounds to bf16).  A causal row that
sees no key returns 0 in the kernel and in the port, where the oracle's
softmax gives NaN: that case is compared with interpret mode only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SHAPES = [
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 8, 1, 100, 100, 64, True, 0),
    (1, 4, 4, 1, 300, 32, True, 299),
    (2, 2, 2, 48, 96, 16, True, 48),
    (1, 2, 1, 64, 64, 32, False, 0),
    (1, 2, 2, 40, 72, 128, False, 0),
]
TOL = {"float32": 3e-5, "bfloat16": 3e-2}


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
def test_plain_flash_matches_pallas_interpret_and_oracle(shape, dtype):
    causal, off = shape[6], shape[7]
    (jq, jk, jv), (q, k, v) = _inputs(shape, dtype)
    got = ops.flash_attention(q, k, v, causal=causal, kv_offset=off)
    assert got.dtype == q.dtype and got.shape == q.shape
    kern = pallas_flash(jq, jk, jv, causal=causal, kv_offset=off,
                        block_q=32, block_kv=32, interpret=True)
    want = jref.flash_attention(jq, jk, jv, causal=causal, kv_offset=off)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(kern), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_dead_rows_return_zero_as_the_kernel():
    """kv_offset -3: query rows 0-2 see no key.  The kernel writes 0 there;
    the oracle's softmax over all -inf gives NaN."""
    shape = (1, 4, 2, 8, 8, 32, True, -3)
    (jq, jk, jv), (q, k, v) = _inputs(shape, "float32", seed=1)
    got = ops.flash_attention(q, k, v, causal=True, kv_offset=-3)
    kern = pallas_flash(jq, jk, jv, causal=True, kv_offset=-3, block_q=8,
                        block_kv=8, interpret=True)
    assert torch.all(got[:, :, :3] == 0)
    np.testing.assert_allclose(_f32(got), _f32(kern), rtol=3e-5, atol=3e-5)
    assert np.isnan(_f32(jref.flash_attention(
        jq, jk, jv, causal=True, kv_offset=-3))[:, :, :3]).all()


def test_scale_and_modes():
    (jq, jk, jv), (q, k, v) = _inputs((1, 4, 2, 16, 24, 32), "float32", 2)
    got = ops.flash_attention(q, k, v, causal=False, scale=0.3, mode="ref")
    want = jref.flash_attention(jq, jk, jv, causal=False, scale=0.3)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-5, atol=3e-5)
    # "auto" on CPU tensors is the plain version, and launches nothing
    ops.reset_launch_counts()
    auto = ops.flash_attention(q, k, v, causal=False, scale=0.3)
    torch.testing.assert_close(auto, got, rtol=1e-6, atol=1e-7)
    assert ops.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, mode="pallas")


@pytest.mark.parametrize("group,lq,dh,elem", [
    (4, 1, 128, 2), (4, 1, 128, 4), (4, 4096, 128, 2), (4, 512, 128, 2),
    (1, 64, 32, 4), (8, 100, 64, 2), (3, 7, 16, 4)])
def test_kernel_tiling_fits_the_card(group, lq, dh, elem):
    """The CTA shape `plan` picks: every (head, position) row of the
    group in some tile, 128 threads, and shared memory under the H100's
    227 KB; a decode step (Lq = 1) has its keys split over at least
    2 x 132 CTAs, on the decode body in bf16."""
    dtype = torch.bfloat16 if elem == 2 else torch.float32
    p = flash_mod.plan((4, 8 * group, lq, dh), (4, 8, 1664, dh), dtype,
                       causal=False)
    assert 1 <= p.positions <= lq and 1 <= p.heads <= group
    assert p.head_tiles * p.heads >= group and p.pos_tiles * p.positions >= lq
    assert p.threads == 128 and p.rows <= (16 if p.body == "cuda_core"
                                           else 64)
    assert p.smem <= flash_mod.SMEM_LIMIT
    if lq == 1 and group == 4:
        assert p.body == ("decode" if elem == 2 else "cuda_core")
        assert p.ctas >= 2 * flash_mod.SMS
