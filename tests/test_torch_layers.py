"""The port's transformer layers (repro_torch.models.layers) against the JAX
package's (repro.models.layers) on the same numpy inputs.

Everything runs in fp32 on the CPU; the bound is 1e-5 absolute, the
rounding left by two frameworks summing in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

ATOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def _both(tree):
    """The same numpy tree as JAX arrays and as torch tensors."""
    j = {k: jnp.asarray(v) for k, v in tree.items()}
    t = {k: torch.from_numpy(v) for k, v in tree.items()}
    return j, t


@pytest.mark.parametrize("shape", [(2, 5, 24), (3, 72)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = _rand(rng, *shape, scale=3.0)
    pj, pt = _both({"scale": _rand(rng, shape[-1])})
    _close(tl.rms_norm(pt, torch.from_numpy(x)),
           jl.rms_norm(pj, jnp.asarray(x)))


def test_rms_norm_scale_stays_fp32_under_bf16_weights():
    """layers.py:58: the norm scale is fp32 whatever the weights' dtype."""
    p = tl.init_rmsnorm(16, (3,), device="cpu")
    assert p["scale"].dtype == torch.float32
    assert p["scale"].shape == (3, 16)


@pytest.mark.parametrize("theta", [1e4, 1e5])
def test_rope_half_split(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 5, 3, 16)
    pos = rng.integers(0, 300, (2, 5))
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    _close(tl.rope_freqs(16, theta), jl.rope_freqs(16, theta))


@pytest.mark.parametrize("act,gated", [("gelu", False), ("silu", True),
                                       ("relu", False)])
def test_mlp(act, gated):
    rng = np.random.default_rng(2)
    d, f = 24, 40
    w = {"w_in": _rand(rng, d, f, scale=d ** -0.5),
         "w_out": _rand(rng, f, d, scale=f ** -0.5)}
    if gated:
        w["w_gate"] = _rand(rng, d, f, scale=d ** -0.5)
    pj, pt = _both(w)
    x = _rand(rng, 2, 3, d)
    _close(tl.mlp(pt, torch.from_numpy(x), act),
           jl.mlp(pj, jnp.asarray(x), act))


@pytest.mark.parametrize("bias", [False, True])
def test_project_qkv(bias):
    rng = np.random.default_rng(3)
    d, h, kvh, dh = 32, 4, 2, 8
    w = {"wq": _rand(rng, d, h, dh), "wk": _rand(rng, d, kvh, dh),
         "wv": _rand(rng, d, kvh, dh)}
    if bias:
        w.update(bq=_rand(rng, h, dh), bk=_rand(rng, kvh, dh),
                 bv=_rand(rng, kvh, dh))
    pj, pt = _both(w)
    kw = dict(d_model=d, n_heads=h, n_kv_heads=kvh, head_dim=dh,
              qkv_bias=bias, rope_theta=1e5)
    x = _rand(rng, 2, 5, d)
    pos = np.broadcast_to(np.arange(5), (2, 5)).copy()
    got = tl._project_qkv(pt, tl.AttnConfig(**kw), torch.from_numpy(x),
                          torch.from_numpy(pos))
    want = jl._project_qkv(pj, jl.AttnConfig(**kw), jnp.asarray(x),
                           jnp.asarray(pos))
    for g, w_ in zip(got, want):
        _close(g, w_)


@pytest.mark.parametrize("window", [-1, 3])
@pytest.mark.parametrize("rep", [1, 3])
def test_sdpa_masked(window, rep):
    rng = np.random.default_rng(4)
    b, sq, sk, hkv, dh = 2, 6, 6, 2, 8
    q = _rand(rng, b, sq, hkv * rep, dh)
    k = _rand(rng, b, sk, hkv, dh)
    v = _rand(rng, b, sk, hkv, dh)
    pos = np.broadcast_to(np.arange(sq), (b, sq)).copy()
    mt = tl.attention_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                           causal=True, window=window)
    mj = jl.attention_mask(jnp.asarray(pos), jnp.asarray(pos), causal=True,
                           window=window)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    _close(tl.sdpa(*map(torch.from_numpy, (q, k, v)), mt, 0.3),
           jl.sdpa(*map(jnp.asarray, (q, k, v)), mj, 0.3))


def test_sdpa_q_chunked_matches_jax():
    rng = np.random.default_rng(5)
    b, s, h, hkv, dh = 1, 11, 4, 2, 8
    q, k, v = (_rand(rng, b, s, n, dh) for n in (h, hkv, hkv))
    pos = np.arange(s)[None]
    got = tl.sdpa_q_chunked(*map(torch.from_numpy, (q, k, v)),
                            torch.from_numpy(pos), torch.from_numpy(pos),
                            causal=True, window=4, scale=0.35, chunk=4)
    want = jl.sdpa_q_chunked(*map(jnp.asarray, (q, k, v)), jnp.asarray(pos),
                             jnp.asarray(pos), causal=True, window=4,
                             scale=0.35, chunk=4)
    _close(got, want)


def test_embed_and_tied_unembed():
    rng = np.random.default_rng(6)
    vocab_pad, d = 128, 24
    pj, pt = _both({"w": _rand(rng, vocab_pad, d, scale=d ** -0.5)})
    toks = rng.integers(0, 100, (2, 5))
    xt = tl.embed(pt, torch.from_numpy(toks))
    xj = jl.embed(pj, jnp.asarray(toks))
    _close(xt, xj)
    _close(tl.unembed(pt, xt), jl.unembed(pj, xj))
    assert tl.unembed(pt, xt.to(torch.bfloat16)).dtype == torch.float32


def test_untied_unembed():
    rng = np.random.default_rng(7)
    pj, pt = _both({"w": _rand(rng, 24, 128, scale=0.2)})
    x = _rand(rng, 3, 24)
    _close(tl.apply_unembed(pt, torch.from_numpy(x)),
           jl.apply_unembed(pj, jnp.asarray(x)))
