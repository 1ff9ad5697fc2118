"""The port's chunkwise mLSTM and xLSTM layers against the reference.

The plain `kernels/ref.mlstm_chunked` is the reference oracle's scan op for
op, so it is held against that oracle (`repro.kernels.ref.mlstm_chunked`)
and against the Pallas kernel in interpret mode, on the shapes of the
reference's sweep (`tests/test_kernels.py::test_mlstm_kernel_matches_ref`)
plus Dh 256 (xlstm-350m's head width) at chunk 64, at that sweep's rtol and
atol 2e-4.  Its gradient (autograd) is held against `jax.vjp` of the
oracle within 1e-5 relative norm per input: both differentiate the same f32
ops, so they part only by the order of their sums.  The layers take the
same numpy parameters on both sides; wherever a value passes a bf16 einsum
the tolerance is 2e-2 (the bf16 step is 2^-8, and XLA and torch round at
different places).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm import mlstm_chunked as pallas_mlstm  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.kernels import mlstm as mlstm_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402

SHAPES = [(1, 2, 64, 16, 16), (2, 1, 128, 32, 32), (1, 4, 96, 8, 48),
          (2, 2, 32, 64, 32), (1, 1, 128, 256, 64)]
BF = dict(rtol=2e-2, atol=2e-2)


def _inputs(b, h, l, dh, seed=0):
    """numpy inputs drawn as the reference's sweep draws them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, l, dh)).astype(np.float32) * 0.5
    k = rng.normal(size=(b, h, l, dh)).astype(np.float32) * 0.5
    v = rng.normal(size=(b, h, l, dh)).astype(np.float32)
    logi = np.clip(rng.normal(size=(b, h, l)), -8, 4).astype(np.float32)
    logf = (-np.abs(rng.normal(size=(b, h, l))) * 0.2).astype(np.float32)
    return [q, k, v, logi, logf]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_oracle_and_pallas_interpret(shape):
    b, h, l, dh, chunk = shape
    arrs = _inputs(b, h, l, dh)
    got = ref.mlstm_chunked(*map(torch.from_numpy, arrs), chunk=chunk)
    want = jref.mlstm_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    kern = pallas_mlstm(*map(jnp.asarray, arrs), chunk=chunk, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (b, h, l, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", SHAPES[:4] + [(1, 2, 128, 64, 64)],
                         ids=str)
def test_plain_backward_matches_jax_vjp(shape):
    b, h, l, dh, chunk = shape
    arrs = _inputs(b, h, l, dh, seed=1)
    dout = np.random.default_rng(2).normal(size=(b, h, l, dh)).astype(
        np.float32)
    tins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = ref.mlstm_chunked(*tins, chunk=chunk)
    grads = torch.autograd.grad(out, tins, torch.from_numpy(dout))
    _, vjp = jax.vjp(lambda *x: jref.mlstm_chunked(*x, chunk=chunk),
                     *map(jnp.asarray, arrs))
    for name, g, jg in zip(("q", "k", "v", "logi", "logf"), grads,
                           vjp(jnp.asarray(dout))):
        jg = np.asarray(jg)
        rel = np.linalg.norm(g.numpy() - jg) / np.linalg.norm(jg)
        assert rel <= 1e-5, (name, rel)


def test_parts_recombine_and_wrapper_runs_plain_on_cpu():
    """On CPU tensors the wrapper (and ops in "auto" and "ref") is the plain
    version bit for bit and launches nothing; out = num / max(|den|,
    exp(-m))."""
    arrs = [torch.from_numpy(a) for a in _inputs(2, 2, 64, 16)]
    want = ref.mlstm_chunked(*arrs, chunk=16)
    num, den, m = ref.mlstm_parts(*arrs, chunk=16)
    assert torch.equal(want, num / torch.maximum(den.abs(),
                                                 torch.exp(-m))[..., None])
    ops.reset_launch_counts()
    for got in (mlstm_mod.mlstm_chunked(*arrs, chunk=16),
                ops.mlstm_chunked(*arrs, chunk=16),
                ops.mlstm_chunked(*arrs, chunk=16, mode="ref")):
        assert torch.equal(got, want)
    counts = ops.launch_counts()
    assert counts["mlstm_fwd"] == counts["mlstm_bwd"] == 0
    with pytest.raises(ValueError):
        ops.mlstm_chunked(*arrs, chunk=16, mode="pallas")


@pytest.mark.parametrize("w", [16, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("dh", [8, 24, 32, 64, 128, 256])
def test_tiling_fits_one_cta(w, dh):
    """Every chunk 16-128 and Dh 8-256 gets a value tile whose forward and
    backward fit the H100's 227 KiB of shared memory per CTA; the source is
    specialised by #defines with nothing left to fill."""
    tv = mlstm_mod.tiling(w, dh)
    assert tv in mlstm_mod.TILES
    assert mlstm_mod.smem_bytes(True, w, tv, dh) <= mlstm_mod.SMEM_LIMIT
    assert mlstm_mod.smem_bytes(False, w, tv, dh) <= mlstm_mod.SMEM_LIMIT
    src = mlstm_mod.source(w, tv)
    assert f"#define W {w}\n#define TV {tv}" in src and "//@" not in src


def test_tiling_refuses_what_the_kernel_cannot_run():
    for w in (8, 40, 256):
        with pytest.raises(ValueError):
            mlstm_mod.tiling(w, 64)
    assert mlstm_mod.tiling(64, 256) == 64     # the slice's shape: 4 tiles


def _layer_params(kind, cfg, seed):
    """The same numpy parameters for both packages' layer."""
    rng = np.random.default_rng(seed)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    if kind == "mlstm":
        shapes = {"wq": (d, h, dh), "wk": (d, h, dh), "wv": (d, h, dh),
                  "wi": (d, h), "wf": (d, h), "wo": (h, dh, d),
                  "wog": (d, h, dh)}
    else:
        shapes = {"wz": (d, d), "wi": (d, d), "wf": (d, d), "wo_g": (d, d),
                  "r": (h, d // h, d // h), "wout": (d, d)}
    return {k: (rng.normal(size=s) * s[0] ** -0.5).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_match_reference(kind):
    cfg = C.get("xlstm-350m", smoke=True)
    p = _layer_params(kind, cfg, 3)
    x = np.random.default_rng(4).normal(size=(2, 128, cfg.d_model)).astype(
        np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if kind == "mlstm":
        got = R.mlstm_block(tp, torch.from_numpy(x), chunk=cfg.mlstm_chunk)
        want = JR.mlstm_block(jp, jnp.asarray(x), chunk=cfg.mlstm_chunk)
    else:
        got = R.slstm_block(tp, torch.from_numpy(x))
        want = JR.slstm_block(jp, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **BF)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_steps_match_reference(kind):
    """Three decode steps through each block's state."""
    cfg = C.get("xlstm-350m", smoke=True)
    p = _layer_params(kind, cfg, 5)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if kind == "mlstm":
        st = R.mlstm_init_state(2, cfg.n_heads, cfg.head_dim)
        jst = JR.mlstm_init_state(2, cfg.n_heads, cfg.head_dim)
        step, jstep = R.mlstm_step, JR.mlstm_step
    else:
        st = R.slstm_init_state(2, cfg.d_model)
        jst = JR.slstm_init_state(2, cfg.d_model)
        step, jstep = R.slstm_step, JR.slstm_step
    rng = np.random.default_rng(6)
    for _ in range(3):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        y, st = step(tp, torch.from_numpy(x), st)
        jy, jst = jstep(jp, jnp.asarray(x), jst)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **BF)
        for k in st:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       **BF)


def test_chunked_forward_equals_token_recurrence():
    """The chunkwise scan and the token-by-token recurrence of `mlstm_cell`
    (mlstm_step's math, another algorithm with its own stabiliser) give
    the same function: within 1e-4 at L 256, Dh 32 in f32."""
    q, k, v, logi, logf = map(torch.from_numpy, _inputs(1, 2, 256, 32, 7))
    want = ref.mlstm_chunked(q, k, v, logi, logf, chunk=64)
    st = R.mlstm_init_state(1, 2, 32)
    outs = []
    for t in range(256):
        y, st = R.mlstm_cell(q[:, :, t], k[:, :, t], v[:, :, t],
                             logi[:, :, t], logf[:, :, t], st)
        outs.append(y)
    torch.testing.assert_close(torch.stack(outs, 2), want, rtol=1e-4,
                               atol=1e-4)
