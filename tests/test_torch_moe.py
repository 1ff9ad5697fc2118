"""The port's MoE block (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`), on the CPU.

moonshot-v1-16b-a3b and arctic-480b SMOKE (8 experts, top 2) take the
reference's `init_moe` weights and the same numpy tokens [2, 64, 64].
Routing is held exactly: each token's experts, each assignment's buffer
position and whether it is kept, the capacity and the drop count, at
capacity factors 4.0 (nothing dropped), 1.25 and 0.05 (many dropped), under
`moe_groups` and under a bf16 payload.  At SMOKE the router's bf16 product
gives the reference's logits bit for bit, and the test asserts it.  The
block's output is held as the attention configs' logits are
(`tests/test_torch_train.py`: 2e-2 relative + 4e-2, mean 4e-3: the experts'
bf16 products, rounded at other places by XLA and torch), its gradients
(x and every MoE leaf, for one cotangent) per tensor to 5e-2 relative norm.

At moonshot's full router width (d 2048, 64 experts, top 6, 4096 tokens)
bf16-rounded logits with ties at the k-th place go to both sides' routing
as one f32 array: experts and gates bit-equal.  The combine adds each
token's k contributions in the reference's scatter order, bit for bit on
contributions whose sums depend on the order.
"""
import io
import re
import tokenize
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import perf as jperf  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import perf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64

# (name, moe_block keyword arguments, perf options on both sides)
CASES = [
    ("capacity factor 4.0", {"capacity_factor": 4.0}, {}),
    ("capacity factor 1.25", {}, {}),
    ("capacity factor 0.05", {}, {"moe_capacity_factor": 0.05}),
    ("moe_groups", {}, {"moe_groups": True}),
    ("bf16 payload", {}, {"moe_payload_dtype": "bf16"}),
]


def _dtypes(opts, side):
    """The options as the given side takes them (a payload dtype is a torch
    dtype in the port, a jnp one in the reference)."""
    out = dict(opts)
    if "moe_payload_dtype" in out:
        out["moe_payload_dtype"] = (torch.bfloat16 if side == "port"
                                    else jnp.bfloat16)
    return out


def _ref_route(logits, k, ne, cf):
    """The reference's routing intermediates (repro/models/moe.py:47-63,
    those lines as they are)."""
    n_tok = logits.shape[0]
    gates, experts = jax.lax.top_k(logits, k)
    gates = jax.nn.softmax(gates, axis=-1)
    exp_idx = experts.reshape(-1)
    capacity = max(int(cf * n_tok * k / ne), 4)
    capacity = -(-capacity // 4) * 4
    order = jnp.argsort(exp_idx, stable=True)
    exp_sorted = exp_idx[order]
    first = jnp.searchsorted(exp_sorted, exp_sorted, side="left")
    pos = jnp.arange(exp_sorted.shape[0]) - first
    return {"experts": np.asarray(experts), "gates": np.asarray(gates),
            "order": np.asarray(order), "pos": np.asarray(pos),
            "keep": np.asarray(pos < capacity), "capacity": capacity}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module", params=["moonshot-v1-16b-a3b",
                                        "arctic-480b"])
def arch(request):
    return request.param


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_block_matches_reference(arch, case):
    _, kw, opts = case
    cfg, jcfg = C.get(arch, smoke=True), JC.get(arch, smoke=True)
    values, _ = JL.split_params(JM.init_moe(jax.random.PRNGKey(3), jcfg))
    values = jax.tree.map(np.asarray, values)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    # the reference: output, stats and gradients for one cotangent
    def jloss(p, xx):
        out, st = JM.moe_block(p, xx, jcfg, **kw)
        return jnp.sum(out * ct), (out, st)

    with jperf.options(**_dtypes(opts, "ref")):
        (_, (jout, jst)), (jgp, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(values, jnp.asarray(x))
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in values.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    with perf.options(**_dtypes(opts, "port")):
        out, st = M.moe_block(p, tx, cfg, **kw)
        cf = perf.get("moe_capacity_factor", kw.get("capacity_factor", 1.25))
        groups = perf.get("moe_groups")
    (out * torch.from_numpy(ct)).sum().backward()

    # routing, exactly: per batch row under moe_groups, else all tokens
    rows = ([x[i] for i in range(B)] if groups
            else [x.reshape(B * S, cfg.d_model)])
    for xr in rows:
        logits = L.dense(torch.from_numpy(xr), p["router"].detach()).float()
        jlogits = JL.dense(jnp.asarray(xr), values["router"]).astype(
            jnp.float32)
        np.testing.assert_array_equal(logits.numpy(), np.asarray(jlogits))
        r = M.route(logits, cfg.top_k, cf)
        want = _ref_route(jlogits, cfg.top_k, cfg.n_experts, cf)
        assert r.capacity == want["capacity"]
        for name in ("experts", "order", "pos", "keep", "gates"):
            np.testing.assert_array_equal(getattr(r, name).numpy(),
                                          want[name], err_msg=name)
    assert st["capacity"] == int(jst["capacity"])
    assert int(st["dropped"]) == int(jst["dropped"])
    if cf == 4.0:
        assert int(st["dropped"]) == 0
    if cf == 0.05:
        assert int(st["dropped"]) > B * S * cfg.top_k // 2

    got, jout = out.detach().numpy(), np.asarray(jout)
    np.testing.assert_allclose(got, jout, rtol=2e-2, atol=4e-2)
    assert float(np.abs(got - jout).mean()) <= 4e-3
    assert _rel(tx.grad.numpy(), np.asarray(jgx)) <= 5e-2, "x"
    for k in values:
        assert _rel(p[k].grad.numpy(), np.asarray(jgp[k])) <= 5e-2, k


def test_full_width_routing_with_ties_is_bit_equal():
    """moonshot-v1-16b-a3b's router at full width: 4096 tokens, 64
    experts, top 6.  The logits are a bf16 product's (rounded to bf16, held
    as f32), so some rows tie at the 6th place; `torch.topk` is free to
    order ties as it likes, the port's stable sort takes the lower expert
    first, as `jax.lax.top_k` does."""
    cfg = C.get("moonshot-v1-16b-a3b")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4096, cfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((cfg.d_model, cfg.n_experts))
         * cfg.d_model ** -0.5).astype(np.float32)
    logits = torch.from_numpy(x @ w).to(torch.bfloat16).float()
    srt = np.sort(logits.numpy(), axis=1)[:, ::-1]
    ties = int((srt[:, cfg.top_k - 1] == srt[:, cfg.top_k]).sum())
    assert ties >= 1
    r = M.route(logits, cfg.top_k, 1.25)
    want = _ref_route(jnp.asarray(logits.numpy()), cfg.top_k,
                      cfg.n_experts, 1.25)
    for name in ("experts", "gates", "order", "pos", "keep"):
        np.testing.assert_array_equal(getattr(r, name).numpy(), want[name],
                                      err_msg=name)
    assert r.capacity == want["capacity"] == 480


def test_combine_adds_in_the_reference_order():
    """Contributions from 1e-8 to 1e8 in size, so that their f32 sum
    depends on the order of the additions: the port's combine equals the
    reference's scatter-add bit for bit, and the sum in descending expert
    order does not."""
    rng = np.random.default_rng(1)
    n_tok, k, ne, d = 256, 6, 64, 16
    experts = np.stack([rng.permutation(ne)[:k] for _ in range(n_tok)])
    order = np.argsort(experts.reshape(-1), kind="stable")
    contrib = (rng.standard_normal((n_tok * k, d))
               * 10.0 ** rng.uniform(-8, 8, (n_tok * k, 1))).astype(
                   np.float32)
    want = np.asarray(jnp.zeros((n_tok, d), jnp.float32).at[
        jnp.asarray(order // k)].add(jnp.asarray(contrib)))
    by_token = M.token_order(torch.from_numpy(order), k)
    got = M.combine(torch.from_numpy(contrib)[by_token], k)
    np.testing.assert_array_equal(got.numpy(), want)
    rev = M.combine(torch.from_numpy(contrib)[by_token.view(-1, k).flip(1)
                                              .reshape(-1)], k)
    assert not np.array_equal(rev.numpy(), want)


def test_moe_source_has_no_accumulating_scatter():
    """No float atomics on the card (ROADMAP's parity contract): the
    module adds nothing through index_add_, scatter_add or an accumulating
    index_put."""
    src = (ROOT / "src/repro_torch/models/moe.py").read_text()
    code = " ".join(t.string for t in tokenize.generate_tokens(
        io.StringIO(src).readline)
        if t.type not in (tokenize.STRING, tokenize.COMMENT))
    for pattern in (r"index_add", r"scatter_add", r"scatter_reduce",
                    r"accumulate\s*=\s*True"):
        assert not re.search(pattern, code), pattern
    assert "index_put_" in code and "argsort" in code    # the code is read


def test_perf_options_scope_and_refuse_a_mesh():
    assert perf.get("moe_groups") is None
    with perf.options(moe_groups=True, moe_capacity_factor=2.0):
        with perf.options(moe_capacity_factor=3.0):
            assert perf.get("moe_capacity_factor") == 3.0
            assert perf.get("moe_groups") is True
        assert perf.get("moe_capacity_factor") == 2.0
    assert perf.get("moe_capacity_factor", 1.25) == 1.25
    x = torch.ones(3)
    assert perf.constrain(x, "act_spec") is x
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        with perf.options(mesh=object()):
            pass
