"""The port's RG-LRU block (Griffin / RecurrentGemma) against the
reference's, on the CPU.

Both sides take the reference's parameters (`init_rglru` of
recurrentgemma-2b's SMOKE config, carried across as numpy) and the same
seeded numpy inputs.  Tolerances: the scan alone, which runs the same f32
multiplies and adds in `jax.lax.associative_scan`'s order, 1e-6 relative
(XLA may contract a multiply and an add into one rounding), and 1e-5
against a float64 sequential recurrence; the block 2e-2 (its projections
are bf16 einsums, which XLA and torch round at different places; the bf16
step is 2^-8); step-by-step decode against the parallel scan 2e-3 (the
reference's own bound, `tests/test_models.py:129`); gradients 5e-2 relative
norm per leaf (bf16-rounded cotangents through the same einsums).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402

ARCH = "recurrentgemma-2b"


@pytest.fixture(scope="module")
def cfg():
    return C.get(ARCH, smoke=True)


@pytest.fixture(scope="module")
def ref_params():
    vals, _ = JL.split_params(JR.init_rglru(jax.random.PRNGKey(3),
                                            JC.get(ARCH, smoke=True)))
    return jax.tree.map(np.asarray, vals)


def _port(ref_params, grad=False):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(grad)
            for k, v in ref_params.items()}


def _x(b, l, d, seed=0, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(b, l, d)) * scale
            ).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _combine(x, y):
    return x[0] * y[0], y[0] * x[1] + y[1]


@pytest.mark.parametrize("l", [1, 2, 3, 7, 16, 33, 64])
def test_scan_matches_associative_scan_and_the_recurrence(l):
    rng = np.random.default_rng(l)
    a = rng.uniform(0.2, 1.0, size=(2, l, 5)).astype(np.float32)
    b = rng.normal(size=(2, l, 5)).astype(np.float32)
    ga, gb = R._scan(torch.from_numpy(a), torch.from_numpy(b))
    wa, wb = jax.lax.associative_scan(_combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    assert _rel(ga.numpy(), wa) <= 1e-6 and _rel(gb.numpy(), wb) <= 1e-6
    h = np.zeros((2, 5))
    seq = []
    for t in range(l):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        seq.append(h)
    assert _rel(gb.numpy(), np.stack(seq, 1)) <= 1e-5


def test_scan_saves_linear_memory():
    """Autograd keeps about 4 x [B, L, Dr] of the scan's pairs beyond its
    inputs (the recursion halves the length at every level), not the
    2 log2(L) = 20 full-length tensors of a step-doubling scan at L 1024.
    Counted by storage: a saved slice of a saved tensor costs nothing."""
    a = torch.rand((1, 1024, 16), requires_grad=True)
    b = torch.randn((1, 1024, 16), requires_grad=True)
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        R._scan(a, b)
    for t in (a, b):
        storages.pop(t.untyped_storage().data_ptr(), None)
    assert sum(storages.values()) <= 4.5 * a.numel() * 4


def test_block_matches_reference(ref_params, cfg):
    x = _x(2, 24, cfg.d_model)
    got = R.rglru_block(_port(ref_params), torch.from_numpy(x))
    want = JR.rglru_block(ref_params, jnp.asarray(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_block_with_initial_state_matches_reference(ref_params, cfg):
    x = _x(2, 9, cfg.d_model, seed=1)
    h0 = np.random.default_rng(2).normal(size=(2, cfg.d_recurrent)).astype(
        np.float32)
    got = R.rglru_block(_port(ref_params), torch.from_numpy(x),
                        torch.from_numpy(h0))
    want = JR.rglru_block(ref_params, jnp.asarray(x), jnp.asarray(h0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_step_matches_reference(ref_params, cfg):
    rng = np.random.default_rng(4)
    x = _x(2, 1, cfg.d_model, seed=5)
    st = {"h": rng.normal(size=(2, cfg.d_recurrent)).astype(np.float32),
          "conv": rng.normal(size=(2, 3, cfg.d_recurrent)).astype(
              np.float32)}
    y, new = R.rglru_step(_port(ref_params), torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in st.items()})
    wy, wnew = JR.rglru_step(ref_params, jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in st.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=2e-2,
                               atol=2e-2)
    for k in ("h", "conv"):
        assert _rel(new[k].numpy(), wnew[k]) <= 2e-2, k


def test_decode_matches_parallel_scan(ref_params, cfg):
    """Mirrors tests/test_models.py:test_rglru_parallel_scan_matches_
    sequential: 16 single-token steps from the zero state reproduce the
    block's full-sequence output."""
    p = _port(ref_params)
    x = torch.from_numpy(_x(1, 16, cfg.d_model, seed=6))
    full = R.rglru_block(p, x)
    st = R.rglru_init_state(1, cfg.d_recurrent)
    outs = []
    for t in range(16):
        y, st = R.rglru_step(p, x[:, t:t + 1], st)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=2e-3,
                               atol=2e-3)


def test_block_gradient_matches_reference(ref_params, cfg):
    x = _x(2, 32, cfg.d_model, seed=7)
    w = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    p = _port(ref_params, grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    (R.rglru_block(p, xt) * torch.from_numpy(w)).sum().backward()
    jgrads, jgx = jax.grad(
        lambda pp, xx: jnp.sum(JR.rglru_block(pp, xx) * w),
        argnums=(0, 1))(ref_params, jnp.asarray(x))
    assert _rel(xt.grad.numpy(), jgx) <= 5e-2
    for k, g in jgrads.items():
        assert _rel(p[k].grad.numpy(), g) <= 5e-2, k
