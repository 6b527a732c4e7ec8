"""The encoder-decoder family on the port (``repro_torch.models.encdec``,
whisper-large-v3), against the JAX package on the same bridged weights, on
the CPU.

whisper-smoke (2 + 2 layers, d_model 64, 4 heads of 16, 16 audio frames)
in fp32, its zero biases and unit norms of ``init_encdec`` drawn live from
a numpy seed before the tree is bridged, so both packages get the same
arrays and a dropped bias or norm shows. Bounds, as stated in each test:
1e-6 for the single operations (``sinusoids``, ``layer_norm``,
``cross_attention``, the cross cache), 1e-5 for the stacks (the encoder,
the teacher-forced decoder, the decode steps and their caches), each of
max(1, the largest magnitude); the loss 1e-6 relative and its gradients
1e-5 of each leaf's max; bf16 bit for bit. The teacher-forced decoder takes the flash route here (K6-K8's plain
versions) and JAX's its masked ``sdpa``. The JAX calls are jitted and
cached per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_large_v3 as j_whisper
from repro.models import common as jcommon
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro_torch import bridge
from repro_torch.configs import base as t_base
from repro_torch.configs import whisper_large_v3 as t_whisper
from repro_torch.models import common
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tlayers


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The smoke model's ops are far below any parallel grain: one torch
    thread while this file runs, the worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


JCFG = j_whisper.make_smoke()
TCFG = bridge.encdec_config_from_dict(dataclasses.asdict(JCFG))
B, S = 2, 8
MAX_LEN = 12
_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _live(tree, rng):
    """Every bias (q, k, v; the MLP has none) and layer norm of the numpy
    tree drawn N(0, 0.5) around its init value, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _live(v, rng)
        elif k in ("bq", "bk", "bv", "scale", "bias"):
            tree[k] = (v + 0.5 * rng.standard_normal(v.shape)).astype(v.dtype)


def _models(dtype=jnp.float32, cfg=JCFG):
    """(JAX params, the port's bridged copy) of whisper-smoke, live."""
    def make():
        params = jed.init_encdec(jax.random.PRNGKey(0), cfg, dtype).params
        tree = jax.tree.map(np.asarray, params)
        tree = jax.tree.map(np.array, tree)                 # writable
        _live(tree, np.random.default_rng(1))
        tcfg = bridge.encdec_config_from_dict(dataclasses.asdict(cfg))
        return (jax.tree.map(jnp.asarray, tree),
                bridge.encdec_params_from_numpy(tree, tcfg, device="cpu"))
    return _cached(("models", jnp.dtype(dtype).name, cfg.name,
                    cfg.n_enc_layers), make)


def _inputs():
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((B, JCFG.n_audio_ctx, JCFG.d_model)) \
        .astype(np.float32)
    tokens = rng.integers(0, JCFG.vocab, (B, S + 1)).astype(np.int32)
    return frames, tokens


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol, what=""):
    """Max abs difference within ``tol`` x max(1, max |want|)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


_j_encode = jax.jit(lambda p, f: jed.encode(p, JCFG, f))
_j_decode_train = jax.jit(lambda p, t, e: jed.decode_train(p, JCFG, t, e))
_j_cross = jax.jit(lambda p, e: jed.build_cross_cache(p, JCFG, e))
_j_step = jax.jit(lambda p, tok, pos, c: jed.decode_step(p, JCFG, tok, pos, c))


def _jax_encoded():
    jp, _ = _models()
    frames, _ = _inputs()
    return _cached("enc", lambda: _j_encode(jp, jnp.asarray(frames)))


def _port_encoded():
    _, tp = _models()
    frames, _ = _inputs()
    return _cached("t_enc", lambda: ted.encode(tp, TCFG, _t(frames)))


# -- single operations ----------------------------------------------------------

def test_sinusoids():
    """The smoke config's table within 1e-6 of the reference's."""
    _close(ted.sinusoids(16, 64), jed.sinusoids(16, 64), 1e-6)


def test_sinusoids_full_size():
    """At whisper-large-v3's (1500, 1280): the timescales' exp differs from
    XLA's by one fp32 ulp in some channels, which moves a product position
    x timescale by at most one ulp of the largest argument (2^-13 at 1499),
    so the table is held within that plus 1e-6."""
    _close(ted.sinusoids(1500, 1280), jed.sinusoids(1500, 1280),
           2 ** -13 + 1e-6)


def _ln_inputs(dtype, d=64):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 8, d)) * 3 + 1).astype(np.float32)
    params = {"scale": (1 + 0.5 * rng.standard_normal(d)).astype(np.float32),
              "bias": (0.5 * rng.standard_normal(d)).astype(np.float32)}
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return (jlayers.layer_norm({k: jnp.asarray(v) for k, v in params.items()},
                               jx),
            tlayers.layer_norm({k: _t(v) for k, v in params.items()}, tx))


def test_layer_norm_fp32():
    """fp32 within 1e-6."""
    want, got = _ln_inputs(jnp.float32)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("d", [64, 1280])
def test_layer_norm_bf16_bit_for_bit(d):
    """bf16: the reference's op order and roundings, so the same bits."""
    want, got = _ln_inputs(jnp.bfloat16, d)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_init_layernorm():
    ln = tlayers.init_layernorm(8, (3,), device="cpu")
    assert ln["scale"].dtype == ln["bias"].dtype == torch.float32
    assert ln["scale"].shape == (3, 8) and bool((ln["scale"] == 1).all())
    assert not ln["bias"].any()


def test_cross_attention():
    """Decoder layer 0's cross attention (live biases) over an encoder
    output: within 1e-6."""
    jp, tp = _models()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, JCFG.d_model)).astype(np.float32)
    src = rng.standard_normal((B, JCFG.n_audio_ctx, JCFG.d_model)) \
        .astype(np.float32)
    jpa = jax.tree.map(lambda a: a[0], jp["dec"]["cross_attn"])
    tpa = {k: v[0] for k, v in tp["dec"]["cross_attn"].items()}
    want = jlayers.cross_attention(jpa, JCFG.attn_cfg(False), jnp.asarray(x),
                                   jnp.asarray(src))
    got = tlayers.cross_attention(tpa, TCFG.attn_cfg(False), _t(x), _t(src))
    _close(got, want, 1e-6)


# -- parameters -----------------------------------------------------------------

def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_param_tree_matches_reference(device):
    """``init_encdec``'s names, shapes and dtypes are the reference's (bf16
    weights, fp32 norms), on the CPU and the meta device."""
    want = _paths(jax.eval_shape(
        lambda: jed.init_encdec(jax.random.PRNGKey(0), JCFG).params))
    got = _paths(ted.init_encdec(TCFG, seed=0, device=device))
    assert got == want


def test_bridge_round_trip_and_refusal():
    """The bridged tree holds the JAX arrays value for value; a tree of
    another depth is refused."""
    jp, tp = _models()
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        t = tp
        for p in path:
            t = t[p.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    deeper = dataclasses.replace(JCFG, n_dec_layers=3)
    tree = jax.tree.map(np.asarray, jed.init_encdec(
        jax.random.PRNGKey(0), deeper, jnp.float32).params)
    with pytest.raises(ValueError, match="shapes"):
        bridge.encdec_params_from_numpy(tree, TCFG, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        bridge.encdec_config_from_dict({**dataclasses.asdict(JCFG),
                                        "flash_vjp": True})
    assert TCFG == ted.EncDecConfig(**dataclasses.asdict(JCFG))


def test_full_config_param_count():
    """Mirror of tests/test_models_smoke.py::test_whisper_full_param_count:
    the full config's meta-device count within 30% of 1.55e9, and the
    registry entry."""
    cfg = t_whisper.make_config()
    n = sum(t.numel() for t in common.flatten(
        ted.init_encdec(cfg, device="meta"))[0])
    assert abs(n - 1.55e9) / 1.55e9 < 0.3, n
    assert n == jcommon.count_params(jax.eval_shape(
        lambda: jed.init_encdec(jax.random.PRNGKey(0),
                                j_whisper.make_config()).params))
    spec = t_base.get("whisper-large-v3")
    assert spec.kind == "encdec" and spec.make_smoke() == TCFG
    assert cfg.head_dim == 64 and cfg.padded_vocab == 51968


# -- the model ------------------------------------------------------------------

def test_encode():
    """The encoder's output within 1e-5."""
    _close(_port_encoded(), _jax_encoded(), 1e-5)


def test_decode_train_logits():
    """Teacher-forced logits over the padded vocab within 1e-5; the port's
    flash route and its masked-``sdpa`` route (explicit positions) both."""
    jp, tp = _models()
    _, tokens = _inputs()
    want = _j_decode_train(jp, jnp.asarray(tokens[:, :S]), _jax_encoded())
    assert want.shape == (B, S, JCFG.padded_vocab)
    got = ted.decode_train(tp, TCFG, _t(tokens[:, :S]).long(),
                           _port_encoded())
    _close(got, want, 1e-5, "flash route")
    pos = torch.arange(S).expand(B, S)
    got_sdpa = ted.decode_train(tp, TCFG, _t(tokens[:, :S]).long(),
                                _port_encoded(), positions=pos)
    _close(got_sdpa, want, 1e-5, "sdpa route")


def test_loss_and_gradients():
    """``loss_fn`` within 1e-6 relative, and every leaf's gradient within
    1e-5 of that leaf's max against ``jax.grad``."""
    jp, tp = _models()
    frames, tokens = _inputs()
    batch = {"frames": frames, "tokens": tokens[:, :S],
             "labels": tokens[:, 1:]}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jed.loss_fn(p, JCFG, b)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves, rebuild = common.flatten(tp)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    tb = {k: _t(v) for k, v in batch.items()}
    loss, aux = ted.loss_fn(rebuild(leaves), TCFG, tb)
    assert float(aux["tokens"]) == B * S
    assert abs(loss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    grads = rebuild(list(torch.autograd.grad(loss, leaves)))
    for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        t = grads
        for p in path:
            t = t[p.key]
        g = np.asarray(g)
        if path[-1].key == "bk":
            # a key bias shifts every key's score of a query by the same
            # q . bk, which the softmax cancels: zero in exact arithmetic,
            # rounding noise (~1e-8) in both packages
            assert max(float(np.abs(g).max()),
                       float(t.abs().max())) <= 1e-6, path
            continue
        err = float(np.abs(t.numpy() - g).max())
        assert err <= 1e-5 * float(np.abs(g).max()), (path, err)


def test_build_cross_cache():
    """Every decoder layer's cross K and V within 1e-6, in the encoder
    output's dtype."""
    jp, tp = _models()
    want = _j_cross(jp, _jax_encoded())
    got = ted.build_cross_cache(tp, TCFG, _port_encoded())
    assert got.k.dtype == torch.float32
    _close(got.k, want.k, 1e-6, "k")
    _close(got.v, want.v, 1e-6, "v")


def _caches_pair():
    """Fresh JAX and port decode caches (fp32) with the cross caches of
    the encoder output."""
    jp, tp = _models()
    jc = jed.init_dec_caches(JCFG, B, MAX_LEN, jnp.float32)
    jc["cross"] = _j_cross(jp, _jax_encoded())
    tc = ted.init_dec_caches(TCFG, B, MAX_LEN, torch.float32, device="cpu")
    tc["cross"] = ted.build_cross_cache(tp, TCFG, _port_encoded())
    return jc, tc


def _j_step_at(jp, tok, pos, jc):
    return _j_step(jp, jnp.asarray(tok), jnp.asarray(pos, jnp.int32), jc)


def test_decode_steps_logits_and_caches():
    """Six decode steps on the same tokens: each step's logits and the
    self caches after it within 1e-5."""
    jp, tp = _models()
    _, tokens = _inputs()
    jc, tc = _caches_pair()
    for pos in range(6):
        tok = tokens[:, pos:pos + 1]
        jl, jc = _j_step_at(jp, tok, pos, jc)
        tl, tc = ted.decode_step(tp, TCFG, _t(tok).long(), pos, tc)
        assert tl.shape == (B, 1, JCFG.vocab)
        _close(tl, jl, 1e-5, f"logits at {pos}")
        _close(tc["self"].k, jc["self"].k, 1e-5, f"k cache at {pos}")
        _close(tc["self"].v, jc["self"].v, 1e-5, f"v cache at {pos}")


def test_decode_step_matches_decode_train():
    """Step t's logits within 1e-5 of the teacher-forced decoder's at t on
    the same tokens (the decode path against the flash route)."""
    _, tp = _models()
    _, tokens = _inputs()
    want = ted.decode_train(tp, TCFG, _t(tokens[:, :S]).long(),
                            _port_encoded())[..., :TCFG.vocab]
    _, tc = _caches_pair()
    for pos in range(S):
        tl, tc = ted.decode_step(tp, TCFG, _t(tokens[:, pos:pos + 1]).long(),
                                 pos, tc)
        _close(tl[:, 0], want[:, pos], 1e-5, f"step {pos}")


def test_greedy_stream_matches_jax_loop():
    """An 8-token greedy stream after a 2-token prompt, the port's loop
    against a JAX loop of ``decode_step``: the same tokens."""
    jp, tp = _models()
    _, tokens = _inputs()
    jc, tc = _caches_pair()

    def j_next(tok, pos):
        nonlocal jc
        logits, jc = _j_step_at(jp, tok, pos, jc)
        return np.asarray(jnp.argmax(logits[:, 0], -1))

    def t_next(tok, pos):
        logits, _ = ted.decode_step(tp, TCFG, _t(tok).long(), pos, tc)
        return logits[:, 0].argmax(-1).numpy()

    streams = []
    for step in (j_next, t_next):
        out, tok = [], tokens[:, :1]
        for pos in range(9):
            nxt = step(tok, pos)
            if pos == 0:
                tok = tokens[:, 1:2]
                continue
            out.append(nxt.tolist())
            tok = nxt[:, None].astype(np.int32)
        streams.append(out)
    assert len(streams[0]) == 8 and streams[0] == streams[1]


def test_pos_past_cache_refused_where_jax_clamps():
    """At ``pos >= max_len`` the reference's ``dynamic_update_slice``
    clamps the write into the last row (a latent fault: the token's K/V
    overwrite the last position's); the port refuses it, and a negative
    ``pos`` too."""
    jp, tp = _models()
    _, tokens = _inputs()
    jc, tc = _caches_pair()
    tok = tokens[:, :1]
    _, clamped = _j_step_at(jp, tok, MAX_LEN, jc)
    k = np.asarray(clamped["self"].k)
    assert not np.abs(k[:, :, :MAX_LEN - 1]).any()
    assert np.abs(k[:, :, MAX_LEN - 1]).all()
    for pos in (MAX_LEN, MAX_LEN + 5, -1):
        with pytest.raises(ValueError, match="outside the self cache"):
            ted.decode_step(tp, TCFG, _t(tok).long(), pos, tc)
    assert not tc["self"].k.any()


def test_bf16_encoder_block_bit_for_bit():
    """One bf16 encoder block (with the sinusoids and the final norm) gives
    the bits of the reference's operations run one by one (its scan under
    ``jax.disable_jit``): each op rounds to bf16 where XLA's does. Compiled,
    XLA fuses the block's elementwise chains and drops some of those
    roundings (a third of the elements differ then), a property of the
    compiler and not of the model."""
    cfg = dataclasses.replace(JCFG, n_enc_layers=1)
    jp, tp = _models(jnp.bfloat16, cfg)
    frames, _ = _inputs()
    with jax.disable_jit():
        want = jed.encode(jp, cfg, jnp.asarray(frames, jnp.bfloat16))
    tcfg = bridge.encdec_config_from_dict(dataclasses.asdict(cfg))
    got = ted.encode(tp, tcfg, _t(frames).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
