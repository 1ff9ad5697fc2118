"""The port's LM serve path against the reference, on the CPU.

Layers take the same numpy inputs and parameters on both sides.  The whole
slice runs llama-3.2-vision-11b's SMOKE config (5 layers, d 64, 16 context
tokens, one cross-attention layer) with the reference's parameters carried
across by key path: both sides are teacher-forced with the reference's
greedy tokens and every step's logits must agree.  Tolerances: 2e-6 for the
f32 norm; 2e-2 relative (atol 2e-2) wherever a value passes a bf16 einsum,
whose rounding XLA and torch place differently (the bf16 step is 2^-8).
"""
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "llama-3.2-vision-11b"
BF = dict(rtol=2e-2, atol=2e-2)
RNG = np.random.default_rng(0)


def _pair(*shape, scale=1.0):
    a = (RNG.normal(size=shape) * scale).astype(np.float32)
    return a, torch.from_numpy(a)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def cfg():
    return C.get(ARCH, smoke=True)


@pytest.fixture(scope="module")
def ref_params():
    jcfg = JC.get(ARCH, smoke=True)
    values, _ = JL.split_params(JT.init_model(jax.random.PRNGKey(0), jcfg))
    return jax.tree.map(np.asarray, values)


def test_configs_equal_the_reference():
    for arch in JC.all_archs():
        for smoke in (False, True):
            assert C.get(arch, smoke=smoke) .__dict__ == \
                JC.get(arch, smoke=smoke).__dict__, (arch, smoke)


def test_rms_norm_rope_mlp(cfg):
    x, tx = _pair(2, 5, cfg.d_model)
    g, tg = _pair(cfg.d_model)
    np.testing.assert_allclose(_np(L.rms_norm(tx, tg, 1e-6)),
                               _np(JL.rms_norm(jnp.asarray(x), g, 1e-6)),
                               rtol=2e-6, atol=2e-6)
    q, tq = _pair(2, 3, 5, 16)
    pos = np.tile(np.arange(7, 12, dtype=np.int32), (2, 1))
    np.testing.assert_allclose(
        _np(L.rope(tq, torch.from_numpy(pos), 500000.0)),
        _np(JL.rope(jnp.asarray(q), jnp.asarray(pos), 500000.0)),
        rtol=2e-5, atol=2e-5)
    w = {k: _pair(*s, scale=0.1) for k, s in (
        ("wi", (cfg.d_model, cfg.d_ff)), ("wg", (cfg.d_model, cfg.d_ff)),
        ("wo", (cfg.d_ff, cfg.d_model)))}
    np.testing.assert_allclose(
        _np(L.mlp({k: v[1] for k, v in w.items()}, tx)),
        _np(JL.mlp({k: jnp.asarray(v[0]) for k, v in w.items()},
                   jnp.asarray(x))), **BF)


def test_decode_attention(cfg):
    q, tq = _pair(2, 4, 1, 16)
    k, tk = _pair(2, 2, 9, 16)
    v, tv = _pair(2, 2, 9, 16)
    for pos in (0, 4, 8):
        np.testing.assert_allclose(
            _np(L.decode_attention(tq, tk, tv, pos)),
            _np(JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), pos)),
            rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("offset", [None, 3])
def test_attention_causal_with_and_without_cache(cfg, offset):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {k: _pair(*s, scale=d ** -0.5) for k, s in (
        ("wq", (d, hq, dh)), ("wk", (d, hkv, dh)), ("wv", (d, hkv, dh)),
        ("wo", (hq, dh, d)))}
    tp = {k: v[1] for k, v in p.items()}
    jp = {k: jnp.asarray(v[0]) for k, v in p.items()}
    x, tx = _pair(2, 4, d)
    start = offset or 0
    pos = np.tile(np.arange(start, start + 4, dtype=np.int32), (2, 1))
    kw, jkw = {}, {}
    if offset is not None:
        kc, tkc = _pair(2, hkv, 10, dh)
        vc, tvc = _pair(2, hkv, 10, dh)
        kw = dict(kv=(tkc.to(torch.bfloat16), tvc.to(torch.bfloat16)),
                  kv_offset=offset)
        jkw = dict(kv=(jnp.asarray(kc, jnp.bfloat16),
                       jnp.asarray(vc, jnp.bfloat16)), kv_offset=offset)
    y, (k, v) = L.attention(tp, tx, torch.from_numpy(pos), cfg=cfg, **kw)
    jy, (jk, jv) = JL.attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                cfg=cfg, **jkw)
    np.testing.assert_allclose(_np(y), _np(jy), **BF)
    np.testing.assert_allclose(_np(k), _np(jk), **BF)
    np.testing.assert_allclose(_np(v), _np(jv), **BF)


def test_params_from_reference_matches_paths(cfg, ref_params):
    params = convert.params_from_reference(ref_params, cfg, "cpu")
    assert params["blocks"]["slot4"]["xattn"]["wq"].shape == \
        (1, cfg.d_model, cfg.n_heads, cfg.head_dim)
    np.testing.assert_array_equal(
        params["blocks"]["slot4"]["xattn"]["wk"].numpy(),
        ref_params["blocks"]["slot4"]["xattn"]["wk"])
    layout = T.init_model(cfg, generator=None, device="meta")
    assert sorted(params) == sorted(layout)
    missing = {**ref_params, "embed": {}}
    with pytest.raises(KeyError, match="missing.*embed/tok"):
        convert.params_from_reference(missing, cfg, "cpu")
    extra = {**ref_params, "extra": {"w": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="extra.*extra/w"):
        convert.params_from_reference(extra, cfg, "cpu")
    bad = {**ref_params, "final_norm": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="final_norm"):
        convert.params_from_reference(bad, cfg, "cpu")


def test_smoke_decode_matches_reference_per_step(cfg, ref_params):
    """Prompt 4, gen 4, batch 2: eight decode steps, the reference's greedy
    tokens fed to both, the logits of every step compared."""
    b, prompt_len, gen = 2, 4, 4
    jcfg = JC.get(ARCH, smoke=True)
    params = convert.params_from_reference(ref_params, cfg, "cpu")
    ctx = np.random.default_rng(0).standard_normal(
        (b, cfg.n_context_tokens, cfg.d_model)).astype(np.float32)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (b, prompt_len))
    step = jax.jit(functools.partial(JT.decode_step, cfg=jcfg, mode="auto"))
    jstate = JT.init_decode_state(jcfg, b, prompt_len + gen)
    state = T.init_decode_state(cfg, b, prompt_len + gen, device="cpu")
    tok = prompt[:, :1]
    for pos in range(prompt_len + gen - 1):
        jlog, jstate = step(ref_params, jstate, jnp.asarray(tok),
                            jnp.int32(pos), cross_ctx=jnp.asarray(ctx))
        log, state = T.decode_step(params, state, torch.from_numpy(tok), pos,
                                   cfg, cross_ctx=torch.from_numpy(ctx))
        assert log.shape == (b, 1, cfg.vocab) and log.dtype == torch.float32
        np.testing.assert_allclose(_np(log), _np(jlog), **BF,
                                   err_msg=f"step {pos}")
        tok = (prompt[:, pos + 1:pos + 2] if pos + 1 < prompt_len
               else np.array(jnp.argmax(jlog[:, -1], -1))[:, None])
    np.testing.assert_allclose(_np(state["blocks"]["slot0"]["k"]),
                               _np(jstate["blocks"]["slot0"]["k"]), **BF)


def test_serve_smoke_on_cpu_prints_reference_lines(capsys):
    r = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "4", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(rf"arch={ARCH} batch=2 prefill=\d+\.\d\ds "
                        r"decode=\d+\.\d\ds \(\d+\.\d tok/s\)", out[0])
    assert out[1] == "sample generations (token ids):"
    assert r.generated.shape == (2, 4)
    assert re.fullmatch(r"  \[\d+(, \d+){3}\]", out[2])
    assert np.isfinite(r.last_logits.numpy()).all()


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(ARCH, smoke=True, batch=1, prompt_len=1, gen=1)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "moonshot-v1-16b-a3b",
                                  "seamless-m4t-medium"])
def test_unported_blocks_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_model(C.get(arch, smoke=True), generator=None, device="meta")
