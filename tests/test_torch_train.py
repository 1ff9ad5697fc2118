"""The port's training path (xlstm-350m SMOKE) against the reference.

Both sides start from the reference's parameters (`init_model` with
PRNGKey(0), carried across by key path) and take the same numpy batches.
Tolerances: logits 2e-2 (bf16 einsums, which XLA and torch round at
different places; the bf16 step is 2^-8), the loss 2e-3 relative (a mean
over many tokens of those logits), gradients 5e-2 relative norm per leaf,
AdamW 1e-6 relative (the same f32 arithmetic in another order), two
training steps' losses 2e-3 relative, decode vs forward 5e-2 (the
reference's own bound, `tests/test_models.py:79`).
"""
import re
import subprocess
import sys
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
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_loop as tl  # noqa: E402

ARCH = "xlstm-350m"
ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 128


@pytest.fixture(scope="module")
def cfg():
    return C.get(ARCH, smoke=True)


@pytest.fixture(scope="module")
def ref_params():
    jcfg = JC.get(ARCH, smoke=True)
    values, _ = JL.split_params(JT.init_model(jax.random.PRNGKey(0), jcfg))
    return jax.tree.map(np.asarray, values)


def _port_params(ref_params, cfg):
    return tree_map(lambda t: t.requires_grad_(True),
                    convert.params_from_reference(ref_params, cfg, "cpu"))


def _batch(cfg, step=0):
    return SyntheticLM(cfg.vocab, S, B, seed=0).batch(step)


def _leaves(tree):
    leaves, _ = tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in leaves}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_data_matches_reference():
    a = SyntheticLM(512, 64, 4, seed=3).batch(5)
    b = JSyntheticLM(512, 64, 4, seed=3).batch(5)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_convert_takes_recurrent_leaves_by_path(ref_params, cfg):
    params = convert.params_from_reference(ref_params, cfg, "cpu")
    got, want = _leaves(params), _leaves(ref_params)
    assert set(got) == set(want) and "blocks/slot3/mix/r" in got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    bad = jax.tree.map(lambda x: x, ref_params)
    del bad["blocks"]["slot0"]["mix"]["wog"]
    with pytest.raises(KeyError, match="slot0/mix/wog"):
        convert.params_from_reference(bad, cfg, "cpu")


def test_forward_and_loss_match_reference(ref_params, cfg):
    params = _port_params(ref_params, cfg)
    batch = _batch(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = JC.get(ARCH, smoke=True)
    with torch.no_grad():
        logits = T.forward(params, tb, cfg)
        loss = T.loss_fn(params, tb, cfg)
    want = JT.forward(ref_params, jb, jcfg, mode="ref")
    jloss = JT.loss_fn(ref_params, jb, jcfg, mode="ref")
    assert logits.shape == (B, S, cfg.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3)


def test_gradients_match_reference(ref_params, cfg):
    """Per leaf within 5e-2 relative norm on the forward test's batch.  The
    gate weights' gradients sum terms of both signs of bf16-rounded
    cotangents: on the next batch (step 1) the reference's own gradient of
    blocks/slot1/mix/wi moves by 9.8% when its parameters move by a
    relative 1e-6, and the port sits 6.1% from it there; on this batch the
    reference moves by up to 6.2% and the port sits within 2%."""
    params = _port_params(ref_params, cfg)
    batch = _batch(cfg, 0)
    loss = T.loss_fn(params, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, cfg)
    loss.backward()
    jcfg = JC.get(ARCH, smoke=True)
    _, jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, mode="ref"))(ref_params)
    got = _leaves(tree_map(lambda t: t.grad, params))
    want = _leaves(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k].numpy(), want[k]) <= 5e-2, k


def test_softmax_xent_with_mask():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        got = L.softmax_xent(torch.from_numpy(logits), torch.from_numpy(
            labels), None if m is None else torch.from_numpy(m))
        want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("step", [1, 3, 5, 50, 99, 100, 150])
def test_schedule_matches_reference(step):
    c = opt.AdamWConfig(warmup_steps=5, total_steps=100)
    jc = jopt.AdamWConfig(warmup_steps=5, total_steps=100)
    np.testing.assert_allclose(opt.schedule(c, step),
                               float(jopt.schedule(jc, jnp.int32(step))),
                               rtol=1e-6)


def test_optimizer_update_matches_reference():
    """Two AdamW updates of the same params and grads (one large enough to
    be clipped); params, moments and the grad norm agree."""
    rng = np.random.default_rng(1)
    p = {"a": {"w": rng.normal(size=(4, 3))}, "b": rng.normal(size=(5,))}
    p = jax.tree.map(lambda x: x.astype(np.float32), p)
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    tp = tree_map(torch.from_numpy, jax.tree.map(np.copy, p))
    jp = jax.tree.map(jnp.asarray, p)
    state, jstate = opt.init(tp), jopt.init(jp)
    for scale in (0.1, 30.0):
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * scale)
                         .astype(np.float32), p)
        tp, state, m = opt.update(cfg, tp, tree_map(torch.from_numpy, g),
                                  state)
        jp, jstate, jm = jopt.update(jcfg, jp, jax.tree.map(jnp.asarray, g),
                                     jstate)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for got, want in ((tp, jp), (state.m, jstate.m), (state.v, jstate.v)):
            got, want = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), want[k],
                                           rtol=1e-6, atol=1e-7)
    assert state.step == int(jstate.step) == 2


def test_two_train_steps_match_reference(ref_params, cfg):
    """Two steps as `train()` takes them (its step function, optimizer
    state and batches), from the reference's weights, against the
    reference's `train()`."""
    ocfg = opt.AdamWConfig(total_steps=2, warmup_steps=5)
    step = tl.make_train_step(cfg, ocfg)
    params = _port_params(ref_params, cfg)
    state, losses = opt.init(params), []
    data = SyntheticLM(cfg.vocab, S, B, seed=0)
    for i in range(2):
        batch = tree_map(torch.from_numpy, data.batch(i))
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    jtcfg = jtl.TrainConfig(steps=2, opt=jopt.AdamWConfig(
        total_steps=2, warmup_steps=5))
    jout = jtl.train(JC.get(ARCH, smoke=True),
                     iter(JSyntheticLM(cfg.vocab, S, B, seed=0)), jtcfg)
    assert jout["steps"] == 2 and state.step == 2
    np.testing.assert_allclose(losses, jout["losses"], rtol=2e-3)
    assert losses[1] < losses[0]


def test_decode_matches_forward_through_recurrent_state(ref_params, cfg):
    """Teacher-forced decode steps reproduce the forward's logits through
    the mLSTM and sLSTM states (chunked vs stepwise)."""
    params = convert.params_from_reference(ref_params, cfg, "cpu")
    toks = torch.from_numpy(_batch(cfg)["tokens"][:1, :16])
    full = T.forward(params, {"tokens": toks}, cfg)
    state = T.init_decode_state(cfg, 1, 16, device="cpu")
    outs = []
    for pos in range(16):
        lg, state = T.decode_step(params, state, toks[:, pos:pos + 1], pos,
                                  cfg)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=5e-2,
                               atol=5e-2)


def test_training_refuses_what_is_not_ported(cfg):
    with pytest.raises(NotImplementedError, match="Queue 1 slice 8"):
        tl.train(cfg, iter([]), tl.TrainConfig(checkpoint_dir="/nonexistent"),
                 device="cpu")
    dense = C.get("stablelm-1.6b", smoke=True)
    params = T.init_model(dense, generator=None, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="flash backward"):
        T.forward(params, {"tokens": toks}, dense)


def test_launch_train_cpu_smoke_output():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq", "64"], capture_output=True, text=True, cwd=ROOT,
        timeout=300, env={"PYTHONPATH": str(ROOT / "src"),
                          "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert re.fullmatch(
        r"arch=xlstm-350m steps=2 loss \d+\.\d{4} -> \d+\.\d{4} "
        r"\(\d+\.\ds, stragglers=0\)\n", out.stdout), out.stdout
