"""The port's LM serve path against the reference, on the CPU, and the
layers the training path adds (sliding-window attention, the SMOKE trees
of the attention and RG-LRU configs).

Layers take the same numpy inputs and parameters on both sides.  The whole
slice runs llama-3.2-vision-11b's SMOKE config (5 layers, d 64, 16 context
tokens, one cross-attention layer) with the reference's parameters carried
across by key path: both sides are teacher-forced with the reference's
greedy tokens and every step's logits must agree.  Tolerances: 2e-6 for the
f32 norm; 2e-2 relative (atol 2e-2) wherever a value passes a bf16 einsum,
whose rounding XLA and torch place differently (the bf16 step is 2^-8).
Sliding-window attention takes f32 inputs on both sides (its own math, not
bf16 rounding, is the point): 2e-5 forward, 1e-4 relative norm for its
gradient (f32 sums in other orders through two softmaxes).
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


def _paths(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, pre + (k,))
        else:
            yield pre + (k,), v


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "seamless-m4t-medium"])
def test_unported_blocks_raise(arch):
    """The MoE and encoder-decoder blocks, once refused, are ported: the
    port's layout on the meta device has the reference's SMOKE tree, path
    for path and shape for shape (moonshot's blocks carry `moe` and no
    `mlp`; seamless has `enc` and `frontend`)."""
    jcfg = JC.get(arch, smoke=True)
    values, _ = JL.split_params(JT.init_model(jax.random.PRNGKey(0), jcfg))
    layout = dict(_paths(T.init_model(C.get(arch, smoke=True),
                                      generator=None, device="meta")))
    want = {p: tuple(v.shape) for p, v in _paths(values)}
    assert {p: tuple(t.shape) for p, t in layout.items()} == want
    assert all(t.is_meta for t in layout.values())
    if arch == "seamless-m4t-medium":
        assert want[("enc", "blocks", "attn", "wq")][0] == jcfg.enc_layers
    else:
        assert ("blocks", "slot0", "moe", "wi") in want
        assert ("blocks", "slot0", "mlp", "wi") not in want


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "stablelm-1.6b",
                                  "moonshot-v1-16b-a3b", "arctic-480b",
                                  "seamless-m4t-medium",
                                  "llama-3.2-vision-11b"])
def test_params_from_reference_carries_smoke_trees(arch):
    """Every leaf of the reference's SMOKE init lands at its key path with
    its values: the RG-LRU blocks (slot0/1, rem/layer0/1), the local and
    global attention blocks, the MoE blocks (arctic's with the dense
    residual's MLP beside them), the encoder and the frontend."""
    jcfg = JC.get(arch, smoke=True)
    values, _ = JL.split_params(JT.init_model(jax.random.PRNGKey(1), jcfg))
    values = jax.tree.map(np.asarray, values)
    params = convert.params_from_reference(values, C.get(arch, smoke=True),
                                           "cpu")

    got, want = dict(_paths(params)), dict(_paths(values))
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(got[path].numpy(), v)
    if arch == "recurrentgemma-2b":
        assert got[("rem", "layer1", "mix", "lam")].shape == \
            (jcfg.d_recurrent,)
        assert got[("blocks", "slot2", "attn", "wk")].shape == \
            (1, jcfg.d_model, 1, jcfg.head_dim)
    if arch == "arctic-480b":
        assert got[("blocks", "slot0", "moe", "wo")].shape == \
            (jcfg.n_layers, jcfg.n_experts, jcfg.d_ff_expert, jcfg.d_model)
        assert ("blocks", "slot0", "mlp", "wi") in got
    if arch in ("seamless-m4t-medium", "llama-3.2-vision-11b"):
        assert got[("frontend", "proj")].shape == (jcfg.d_model, jcfg.d_model)


def _window_inputs(b, hq, hkv, l, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((b, hq, l, dh), (b, hkv, l, dh), (b, hkv, l, dh),
             (b, hq, l, dh))]


@pytest.mark.parametrize("b,hq,l,w", [(1, 2, 128, 32), (2, 4, 96, 32),
                                      (1, 2, 32, 32)])
def test_windowed_attention_and_its_gradient_match_reference(b, hq, l, w):
    """MQA (one KV head), L = 4w, 3w and L = w (the plain causal call):
    the port's `_windowed_attention` and its gradient (autograd through
    both flash calls, the strided chunk-0 views and the splice) against
    the reference's and jax.vjp of it; also the banded mask of
    tests/test_models.py:test_windowed_attention_matches_banded_reference
    (query i sees keys (i // w - 1) w <= j <= i)."""
    q, k, v, dout = _window_inputs(b, hq, 1, l, 16, seed=l + b)
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = L._windowed_attention(*ins, w, "auto")
    grads = torch.autograd.grad(got, ins, torch.from_numpy(dout))
    want, vjp = jax.vjp(lambda *a: JL._windowed_attention(*a, w, "ref"),
                        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for g, jg in zip(grads, vjp(jnp.asarray(dout))):
        jg = np.asarray(jg)
        assert np.linalg.norm(g.numpy() - jg) <= 1e-4 * np.linalg.norm(jg)
    i, j = np.arange(l)[:, None], np.arange(l)[None, :]
    mask = (j <= i) & (j >= (i // w - 1) * w)
    s = np.einsum("bhid,bhjd->bhij", q, np.repeat(k, hq, 1)) * 16 ** -0.5
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    band = np.einsum("bhij,bhjd->bhid", p / p.sum(-1, keepdims=True),
                     np.repeat(v, hq, 1))
    np.testing.assert_allclose(got.detach().numpy(), band, rtol=2e-4,
                               atol=2e-4)


def test_windowed_attention_reads_chunk_zero_as_strided_views(monkeypatch):
    """The chunk-0 call gets views of the chunked tensors (no copy); the
    windowed call gets kv_offset = w."""
    calls = []
    plain = L.kops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.is_contiguous(), k.is_contiguous(), kw))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(L.kops, "flash_attention", spy)
    q, k, v, _ = _window_inputs(2, 2, 1, 64, 16, seed=0)
    L._windowed_attention(*map(torch.from_numpy, (q, k, v)), 16, "auto")
    assert [c[2]["kv_offset"] for c in calls] == [16, 0]
    assert calls[0][:2] == (True, True) and calls[1][:2] == (False, False)
    with pytest.raises(ValueError, match="multiple of window"):
        L._windowed_attention(*map(torch.from_numpy, (q, k, v)), 24, "auto")
