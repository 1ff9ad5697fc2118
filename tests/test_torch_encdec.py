"""The models whose forward takes a context or routes to experts, against
the reference on the CPU: seamless-m4t-medium (encoder-decoder),
llama-3.2-vision-11b (context tokens through the frontend stub into its
cross-attention layers), moonshot-v1-16b-a3b (MoE) and arctic-480b (MoE
with a dense MLP beside it), all SMOKE.

Both sides start from the reference's parameters (`init_model` with
PRNGKey(0), carried across by key path) and take the same `SyntheticLM`
batch, its context included (seq // frontend_downsample encoder frames for
seamless, n_context_tokens patches for the vision model).  Limits as
`tests/test_torch_train.py` holds the attention configs: logits per element
2e-2 relative + 4e-2 and in mean 4e-3, the loss 2e-3 relative, each
gradient leaf 5e-2 relative norm (the encoder's blocks and final norm and
the frontend's projection among them), two training steps' losses 2e-3
relative.  `remat=True` gives `remat=False`'s loss and gradients bit for
bit.  Decode steps, teacher-forced with the serve path's context as
`cross_ctx`, against the reference's `decode_step` run op by op
(`jax.disable_jit`, as that test does), each step's logits per element as
the forward and in mean 8e-3.

The logits are held against the reference's forward run op by op too
(`jax.disable_jit`, no checkpoint): compiled, XLA keeps bf16
intermediates in f32, and a router logit that moves by one bf16 step
flips an expert choice at a near-tie.  At arctic-480b SMOKE the compiled
reference's logits part from its own op-by-op run at 311 of 65,536
places beyond the limits (and from the port's at 312), where the port
and the op-by-op run part at none.
"""
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.data.tokens import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jtl  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path, tree_map  # noqa: E402
from repro_torch.data.tokens import SyntheticLM  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_loop as tl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
ARCHS = ["seamless-m4t-medium", "llama-3.2-vision-11b",
         "moonshot-v1-16b-a3b", "arctic-480b"]


def _data(cfg, seq=S, batch=B):
    """The training data `launch.train` builds for cfg."""
    return dict(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0,
                context_tokens=(seq // cfg.frontend_downsample
                                if cfg.is_encdec else cfg.n_context_tokens),
                d_model=cfg.d_model)


def _leaves(tree):
    leaves, _ = tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in leaves}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close_logits(got, want, msg="", mean=4e-3):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=4e-2, err_msg=msg)
    assert float(np.abs(got - want).mean()) <= mean, msg


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """One config's SMOKE run on the reference's side: its parameters, the
    forward's batch, logits, loss and gradients."""
    arch = request.param
    jcfg = JC.get(arch, smoke=True)
    values, _ = JL.split_params(JT.init_model(jax.random.PRNGKey(0), jcfg))
    values = jax.tree.map(np.asarray, values)
    cfg = C.get(arch, smoke=True)
    batch = SyntheticLM(**_data(cfg)).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg, mode="ref"))(values)
    with jax.disable_jit():
        jlogits = np.asarray(JT.forward(values, jb, jcfg, mode="ref",
                                        remat=False))
    return types.SimpleNamespace(
        arch=arch, cfg=cfg, jcfg=jcfg, values=values, batch=batch,
        jlogits=jlogits, jloss=float(jloss),
        jgrads=_leaves(jax.tree.map(np.asarray, jgrads)))


def _port_params(values, cfg):
    return tree_map(lambda t: t.requires_grad_(True),
                    convert.params_from_reference(values, cfg, "cpu"))


def _loss_and_grads(lm, remat=True):
    params = _port_params(lm.values, lm.cfg)
    loss = T.loss_fn(params, {k: torch.from_numpy(v)
                              for k, v in lm.batch.items()}, lm.cfg,
                     remat=remat)
    loss.backward()
    return loss.detach(), _leaves(tree_map(lambda t: t.grad, params))


def test_batch_carries_the_context(lm):
    if not lm.cfg.n_context_tokens:
        assert "context" not in lm.batch
        return
    n = S // 4 if lm.cfg.is_encdec else lm.cfg.n_context_tokens
    assert lm.batch["context"].shape == (B, n, lm.cfg.d_model)


def test_forward_and_loss_match_reference(lm):
    params = convert.params_from_reference(lm.values, lm.cfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in lm.batch.items()}
    with torch.no_grad():
        logits = T.forward(params, tb, lm.cfg)
        loss = T.loss_fn(params, tb, lm.cfg)
    assert logits.shape == (B, S, lm.cfg.vocab)
    _close_logits(logits.numpy(), lm.jlogits)
    np.testing.assert_allclose(float(loss), lm.jloss, rtol=2e-3)


def test_gradients_match_reference(lm):
    """Every leaf, the encoder's and the frontend's among them, within 5e-2
    relative norm of `jax.grad`'s."""
    loss, got = _loss_and_grads(lm)
    np.testing.assert_allclose(float(loss), lm.jloss, rtol=2e-3)
    assert set(got) == set(lm.jgrads)
    for k, want in lm.jgrads.items():
        assert float(np.abs(want).max()) > 0, k
        assert _rel(got[k].numpy(), want) <= 5e-2, k
    parts = {k.split("/")[0] for k in got}
    if lm.cfg.is_encdec:
        assert {"enc", "frontend"} <= parts
        assert "enc/blocks/attn/wq" in got
    elif lm.cfg.n_context_tokens:
        assert "frontend" in parts
    else:
        assert "blocks/slot0/moe/wi" in got
        assert ("blocks/slot0/mlp/wi" in got) == lm.cfg.dense_residual


def test_remat_is_bit_equal(lm):
    """The per-super-layer recompute changes what is kept, not a value:
    the routing it recomputes is the forward's, and the gradient of the
    context reaches the encoder and the frontend through the recomputed
    cross-attention."""
    loss_r, grads_r = _loss_and_grads(lm, remat=True)
    loss_n, grads_n = _loss_and_grads(lm, remat=False)
    assert torch.equal(loss_r, loss_n)
    assert set(grads_r) == set(grads_n)
    assert all(torch.equal(grads_r[k], grads_n[k]) for k in grads_n)


def test_decode_matches_reference_decode_step(lm):
    """Batch 2, 10 teacher-forced steps from the forward's tokens, the
    context (the encoder-decoder model's too) passed as `cross_ctx` as
    `launch.serve` passes it."""
    n = 10
    params = convert.params_from_reference(lm.values, lm.cfg, "cpu")
    toks = lm.batch["tokens"][:, :n]
    ctx = None
    if lm.cfg.n_context_tokens:
        ctx = np.random.default_rng(0).standard_normal(
            (B, lm.cfg.n_context_tokens, lm.cfg.d_model)).astype(np.float32)
    state = T.init_decode_state(lm.cfg, B, n, device="cpu")
    jstate = JT.init_decode_state(lm.jcfg, B, n)
    for pos in range(n):
        got, state = T.decode_step(
            params, state, torch.from_numpy(toks[:, pos:pos + 1]), pos,
            lm.cfg, cross_ctx=None if ctx is None else torch.from_numpy(ctx))
        with jax.disable_jit():
            want, jstate = JT.decode_step(
                lm.values, jstate, jnp.asarray(toks[:, pos:pos + 1]),
                jnp.int32(pos), lm.jcfg, mode="ref",
                cross_ctx=None if ctx is None else jnp.asarray(ctx))
        assert got.shape == (B, 1, lm.cfg.vocab)
        _close_logits(got.numpy(), want, f"step {pos}", mean=8e-3)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "seamless-m4t-medium"])
def test_two_train_steps_match_reference(arch):
    """Two steps as `train()` takes them (its step function, optimizer
    state and batches, the context included), from the reference's
    weights, against the reference's `train()`."""
    cfg, jcfg = C.get(arch, smoke=True), JC.get(arch, smoke=True)
    values, _ = JL.split_params(JT.init_model(jax.random.PRNGKey(0), jcfg))
    params = _port_params(jax.tree.map(np.asarray, values), cfg)
    ocfg = opt.AdamWConfig(total_steps=2, warmup_steps=5)
    step = tl.make_train_step(cfg, ocfg)
    state, losses = opt.init(params), []
    data = SyntheticLM(**_data(cfg))
    for i in range(2):
        batch = tree_map(torch.from_numpy, data.batch(i))
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    jout = jtl.train(jcfg, iter(JSyntheticLM(**_data(cfg))),
                     jtl.TrainConfig(steps=2, opt=jopt.AdamWConfig(
                         total_steps=2, warmup_steps=5)))
    assert jout["steps"] == 2 and state.step == 2
    np.testing.assert_allclose(losses, jout["losses"], rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_cpu_smoke_output(arch):
    """Each config trains two steps through the entry point, the context
    going from `SyntheticLM` to `loss_fn` on the device."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq", "32"], capture_output=True, text=True, cwd=ROOT,
        timeout=300, env={"PYTHONPATH": str(ROOT / "src"),
                          "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert re.fullmatch(
        rf"arch={arch} steps=2 loss \d+\.\d{{4}} -> \d+\.\d{{4}} "
        r"\(\d+\.\ds, stragglers=0\)\n", out.stdout), out.stdout
