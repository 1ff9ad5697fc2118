"""The split chunkwise mLSTM (a chunk-state scan plus chunk-parallel work,
the design of csrc/mlstm_tc.cu) in plain PyTorch, and the shape plan that
picks the kernel body.

The split forward (`ref.mlstm_chunk_states`, then `ref.mlstm_chunk_out`)
is held against the plain scan `ref.mlstm_chunked`, the reference's oracle
and the Pallas kernel in interpret mode at the sweep's rtol/atol 2e-4
(tests/test_torch_mlstm.py's), and its backward (the reverse dC scan,
then the chunk-parallel gradients, m held constant: the kernel's
formulas) against `jax.vjp` of the oracle within 1e-5 relative norm per
input, as the plain version's autograd is.  The plan checks run over the
chunk x Dh grid of the CUDA-core body's tiling tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm import mlstm_chunked as pallas_mlstm  # noqa: E402
from repro_torch.kernels import mlstm as mlstm_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SHAPES = [(1, 2, 64, 16, 16), (2, 1, 128, 32, 32), (1, 4, 96, 8, 48),
          (2, 2, 32, 64, 32), (1, 1, 128, 256, 64), (1, 2, 256, 64, 128)]


def _inputs(b, h, l, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, l, dh)).astype(np.float32) * 0.5
    k = rng.normal(size=(b, h, l, dh)).astype(np.float32) * 0.5
    v = rng.normal(size=(b, h, l, dh)).astype(np.float32)
    logi = np.clip(rng.normal(size=(b, h, l)), -8, 4).astype(np.float32)
    logf = (-np.abs(rng.normal(size=(b, h, l))) * 0.2).astype(np.float32)
    return [q, k, v, logi, logf]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_split_forward_matches_plain_oracle_and_pallas(shape):
    b, h, l, dh, chunk = shape
    arrs = _inputs(b, h, l, dh)
    t = list(map(torch.from_numpy, arrs))
    got = ref.mlstm_split(*t, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (b, h, l, dh)
    for want in (ref.mlstm_chunked(*t, chunk=chunk).numpy(),
                 np.asarray(jref.mlstm_chunked(*map(jnp.asarray, arrs),
                                               chunk=chunk)),
                 np.asarray(pallas_mlstm(*map(jnp.asarray, arrs),
                                         chunk=chunk, interpret=True))):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_split_backward_matches_jax_vjp(shape):
    b, h, l, dh, chunk = shape
    arrs = _inputs(b, h, l, dh, seed=1)
    dout = np.random.default_rng(2).normal(size=(b, h, l, dh)).astype(
        np.float32)
    grads = ref.mlstm_split_backward(*map(torch.from_numpy, arrs),
                                     torch.from_numpy(dout), chunk=chunk)
    _, vjp = jax.vjp(lambda *x: jref.mlstm_chunked(*x, chunk=chunk),
                     *map(jnp.asarray, arrs))
    for name, g, jg in zip(("q", "k", "v", "logi", "logf"), grads,
                           vjp(jnp.asarray(dout))):
        jg = np.asarray(jg)
        rel = np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg)
        assert rel <= 1e-5, (name, rel)


def test_chunk_states_are_the_scans_carry():
    """Chunk c's entry state is the plain scan's carry after c chunks: the
    states at the last chunk, advanced once more, give the final state of
    the token recurrence's n (sum of the decayed k), and chunk 0's is 0."""
    b, h, l, dh, chunk = 1, 2, 128, 16, 32
    q, k, v, logi, logf = map(torch.from_numpy, _inputs(b, h, l, dh, 3))
    C, n = ref.mlstm_chunk_states(k, v, logi, logf, chunk=chunk)
    assert C.shape == (b, h, l // chunk, dh, dh)
    assert n.shape == (b, h, l // chunk, dh)
    assert not C[:, :, 0].any() and not n[:, :, 0].any()
    # chunk 1's state from chunk 0 alone, written out
    cum = torch.cumsum(logf[..., :chunk], -1)
    wgt = torch.exp(cum[..., -1:] - cum + logi[..., :chunk])
    want = torch.einsum("bhs,bhsk,bhsv->bhkv", wgt, k[:, :, :chunk],
                        v[:, :, :chunk])
    torch.testing.assert_close(C[:, :, 1], want, rtol=1e-5, atol=1e-6)


def test_dstate_scan_is_the_gradient_of_the_states():
    """The reverse scan's dC for chunk c is the gradient of <out, dout>
    with respect to the state leaving chunk c: autograd through
    `mlstm_chunk_out` with the states as leaves gives dC and dn of the
    states ENTERING each chunk, which are the scan's values one chunk
    later, propagated by e^total (dC_c = e^total_c dC_(c+1) + direct)."""
    b, h, l, dh, chunk = 1, 1, 96, 8, 32
    q, k, v, logi, logf = map(torch.from_numpy, _inputs(b, h, l, dh, 4))
    dout = torch.from_numpy(np.random.default_rng(5).normal(
        size=(b, h, l, dh)).astype(np.float32))
    C, n = ref.mlstm_chunk_states(k, v, logi, logf, chunk=chunk)
    Cl, nl = C.clone().requires_grad_(), n.clone().requires_grad_()
    out, den, m = ref.mlstm_chunk_out(q, k, v, logi, logf, Cl, nl,
                                      chunk=chunk)
    # direct gradients of this chunk's outputs w.r.t. its entry state,
    # with m held constant as the kernel does
    gC, gn = torch.autograd.grad(out, (Cl, nl), dout)
    dC, dn, _, _ = ref.mlstm_dstate_scan(q, logi, logf, out.detach(), dout,
                                         den.detach(), m, chunk=chunk)
    total = torch.cumsum(logf.reshape(b, h, -1, chunk), -1)[..., -1]
    nc = l // chunk
    assert not dC[:, :, -1].any() and not dn[:, :, -1].any()
    for c in range(nc - 1):
        e = torch.exp(total[:, :, c + 1])
        want = gC[:, :, c + 1] + e[..., None, None] * dC[:, :, c + 1]
        torch.testing.assert_close(dC[:, :, c], want, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(
            dn[:, :, c], gn[:, :, c + 1] + e[..., None] * dn[:, :, c + 1],
            rtol=1e-4, atol=1e-5)


def _scan_stage_floats(pl, kernel):
    """Floats of one ring stage of a scan CTA, from the plan's shared
    memory (stages x stage + 2 W + 8)."""
    return (pl.smem[kernel] // 4 - 2 * pl.w - 8) / pl.stages


def _assert_tc_plan_fits(pl):
    """Every kernel of a tensor-core plan fits 227 KiB, the scan tile
    tiles Dh, and each scan stage also holds the [TK][TV + 4] state tile
    that the scan stages through it on its way out."""
    assert max(pl.smem.values()) <= mlstm_mod.SMEM_LIMIT
    assert pl.dh % pl.tk == 0 and pl.dh % pl.tv == 0
    assert pl.tk % 16 == 0 and pl.tv % 16 == 0 and pl.stages >= 2
    for kernel in ("scan_fwd", "scan_bwd"):
        assert pl.tk * (pl.tv + 4) <= _scan_stage_floats(pl, kernel), kernel


@pytest.mark.parametrize("w", [16, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("dh", [8, 24, 32, 64, 128, 256])
def test_plan_fits_one_cta(w, dh):
    """Every chunk 16-128 and Dh 8-256 the CUDA-core body took still runs:
    the tensor-core pair where both are multiples of 16, else the
    CUDA-core body; every kernel of the plan fits the H100's 227 KiB of
    shared memory per CTA (a scan stage, the state tile it stages too),
    and the source is specialised with nothing left to fill."""
    pl = mlstm_mod.plan(w, dh)
    tc = w % 16 == 0 and dh % 16 == 0
    assert pl.body == ("tensor_core" if tc else "cuda_core")
    assert max(pl.smem.values()) <= mlstm_mod.SMEM_LIMIT
    src = pl.source()
    if tc:
        _assert_tc_plan_fits(pl)
        assert (f"#define W {w}\n#define D {dh}\n#define TK {pl.tk}\n"
                f"#define TV {pl.tv}\n#define STAGES {pl.stages}") in src
    else:
        assert pl.tv == mlstm_mod.tiling(w, dh)
    assert "//@" not in src


@pytest.mark.parametrize("w", [16, 32, 48, 64, 96, 128])
def test_sweep_scan_tiles_fit(w):
    """The scan tiles scripts/mlstm_kernel_sweep.py builds (64 x 64,
    128 x 64, 64 x 128, 32 x 32, 2 and 3 stages) at Dh 256: where a plan
    fits, its scan stages hold the state tile too (at chunk 16 the tile,
    not the chunk's operands, sets the stage)."""
    for tk, tv in ((64, 64), (128, 64), (64, 128), (32, 32)):
        for stages in (2, 3):
            pl = mlstm_mod._tc_plan(w, 256, tk, tv, stages)
            if pl is not None:
                _assert_tc_plan_fits(pl)
    pl = mlstm_mod.plan(16, 256)
    assert _scan_stage_floats(pl, "scan_fwd") == pl.tk * (pl.tv + 4)


def test_plan_picks_the_tensor_core_pair_on_the_main_path():
    """The training shape (chunk 64, Dh 256), chunk 128 at Dh 256 and
    SMOKE's heads take the tensor-core pair; at the training shape both
    halves have 512 CTAs ([8, 4, 1024, 256]: 32 heads x 16 chunks; the
    scans (Dh / TV) x (Dh / TK) x B*H, the chunk kernels chunks x B*H)."""
    for w, dh in ((64, 256), (128, 256), (64, 32)):
        assert mlstm_mod.plan(w, dh).body == "tensor_core"
    pl = mlstm_mod.plan(64, 256)
    assert (256 // pl.tv) * (256 // pl.tk) * 32 == 512
    # the sweep's scan tiles: 128 x 64 runs 2 stages (3 do not fit)
    assert mlstm_mod._tc_plan(64, 256, 128, 64, 3).stages == 2
    assert mlstm_mod._tc_plan(64, 256, 64, 64, 3).stages == 3


def test_plan_refuses_what_no_body_runs():
    for w in (8, 40, 256):
        with pytest.raises(ValueError):
            mlstm_mod.plan(w, 64)
    with pytest.raises(ValueError):
        mlstm_mod._tc_plan(64, 256, 48, 64, 2)


def test_tc_smem_is_what_the_source_lays_out():
    """`tc_smem` models csrc/mlstm_tc.cu's constexpr plan for `plan` (the
    launchers take the source's sizes; on the card `layout` reads them and
    chip_smoke.py holds the two equal); both list the same terms."""
    src = mlstm_mod.build.template("mlstm_tc")
    for name in ("STATE_F", "SCAN_SB_F", "SCAN_SB_B", "SCAN_F", "SCAN_B",
                 "OUT_SB", "OUT_F", "BWD_SB", "BWD_F"):
        assert f"constexpr int {name} =" in src
    assert "constexpr int STATE_F = TK * (TV + 4);" in src
    assert "cmax(W * PB(TK) + W * PB(TV) + 2 * W, STATE_F)" in src
    assert mlstm_mod.tc_smem("scan_fwd", 64, 256, 64, 64, 2) == 4 * (
        2 * (64 * 72 + 64 * 72 + 2 * 64) + 2 * 64 + 8)
    # chunk 16: the 64 x 64 state tile (64 x 68) outgrows the operands
    assert mlstm_mod.tc_smem("scan_fwd", 16, 256, 64, 64, 2) == 4 * (
        2 * 64 * 68 + 2 * 16 + 8)
    assert mlstm_mod.tc_smem("out", 64, 256, 64, 64, 2) == 4 * (
        2 * max(2 * 64 * 36, 16 * 264, 64 * 20 + 16 * 264) + 64 * 68
        + 6 * 64 + 256)
