"""The port's decoder (repro_torch.models.transformer) against the JAX
package's on the same weights, bridged array by array through numpy.

Two fp32 models: starcoder2-7b's smoke config (non-gated GELU, GQA 6/2)
and test_serve_core's ``_cfg`` (gated SiLU, 4/2 heads, unpadded vocab 61).
Bounds: 1e-4 on logits and 1e-5 on caches, the bounds the JAX tests hold
their decode kernel to; position tags must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import starcoder2_7b as j_sc2
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import starcoder2_7b as t_sc2
from repro_torch.models import transformer as ttf


def _core_cfg():
    """tests/test_serve_core.py::_cfg."""
    return jtf.LMConfig(name="t", d_model=48, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=61, pattern=(jtf.BlockSpec(),),
                        repeats=2, remat="none", vocab_pad_multiple=1)


CFGS = {"starcoder2-smoke": j_sc2.make_smoke, "serve-core": _core_cfg}


def _models(name):
    jcfg = CFGS[name]()
    params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                         dtype=jnp.float32).params
    tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def _check_caches(jc, tc):
    for key, entry in jc.items():
        np.testing.assert_allclose(tc[key]["kv"].k.numpy(),
                                   np.asarray(entry["kv"].k), atol=1e-5)
        np.testing.assert_allclose(tc[key]["kv"].v.numpy(),
                                   np.asarray(entry["kv"].v), atol=1e-5)
        np.testing.assert_array_equal(tc[key]["pos"].numpy(),
                                      np.asarray(entry["pos"]))


def _padded_prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([8, 5, 1, 3], np.int32)
    toks = rng.integers(0, vocab, (len(lens), 8)).astype(np.int32)
    return toks, lens


@pytest.mark.parametrize("name", sorted(CFGS))
def test_padded_prefill_matches_jax(name):
    jcfg, params, tcfg, tparams = _models(name)
    toks, lens = _padded_prompts(jcfg.vocab)
    lj, cj = jtf.prefill(params, jcfg, jnp.asarray(toks), max_len=16,
                         cache_dtype=jnp.float32, lengths=jnp.asarray(lens))
    lt, ct = ttf.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                         max_len=16, cache_dtype=torch.float32,
                         lengths=torch.from_numpy(lens).long())
    assert lt.shape == (4, 1, jcfg.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    _check_caches(cj, ct)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_per_slot_decode_matches_jax_kernel(name):
    """Three decode steps with per-slot positions: the port's kernel
    branch (its plain version on CPU) against JAX's Pallas kernel."""
    jcfg, params, tcfg, tparams = _models(name)
    jcfg_k = dataclasses.replace(jcfg, decode_kernel=True)
    toks, lens = _padded_prompts(jcfg.vocab, seed=1)
    lj, cj = jtf.prefill(params, jcfg, jnp.asarray(toks), max_len=16,
                         cache_dtype=jnp.float32, lengths=jnp.asarray(lens))
    _, ct = ttf.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                        max_len=16, cache_dtype=torch.float32,
                        lengths=torch.from_numpy(lens).long())
    tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)
    pos = lens.copy()
    for _ in range(3):
        lj, cj = jtf.decode_step(params, jcfg_k, jnp.asarray(tok[:, None]),
                                 jnp.asarray(pos), cj)
        lt, ct = ttf.decode_step(tparams, tcfg,
                                 torch.from_numpy(tok[:, None]).long(),
                                 torch.from_numpy(pos).long(), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        _check_caches(cj, ct)
        tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)
        pos = pos + 1


def test_scalar_position_decode_takes_masked_sdpa():
    """A scalar position (all rows alike) runs the masked-sdpa branch in
    both frameworks and never the kernel."""
    from repro_torch.kernels import decode_attention as k1
    jcfg, params, tcfg, tparams = _models("starcoder2-smoke")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, (2, 6)).astype(np.int32)
    lj, cj = jtf.prefill(params, jcfg, jnp.asarray(toks), max_len=12,
                         cache_dtype=jnp.float32)
    _, ct = ttf.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                        max_len=12, cache_dtype=torch.float32)
    tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)[:, None]
    before = k1.decode_attention.launches
    lj, cj = jtf.decode_step(params, jcfg, jnp.asarray(tok), jnp.asarray(6),
                             cj)
    lt, ct = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok).long(),
                             torch.tensor(6), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    _check_caches(cj, ct)
    assert k1.decode_attention.launches == before


@pytest.mark.parametrize("name", sorted(CFGS))
def test_init_lm_tree_matches_jax_layout(name):
    """The port's own init gives the JAX tree's keys, shapes and dtypes
    (bf16 weights, fp32 norm scales), so bridged and native weights are
    interchangeable."""
    jcfg, params, tcfg, _ = _models(name)
    jb = jtf.init_lm(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16).params
    tb = ttf.init_lm(tcfg, seed=0, dtype=torch.bfloat16, device="cpu")
    flat_j = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
              for p, x in jax.tree_util.tree_flatten_with_path(jb)[0]}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", (tuple(v.shape),
                                           str(v.dtype).split(".")[-1])

    assert dict(walk(tb)) == flat_j


def test_config_bridge_matches_port_config():
    got = bridge.config_from_dict(dataclasses.asdict(j_sc2.make_config()))
    assert got == t_sc2.make_config()
    assert got.padded_vocab == 49152 and got.resolved_head_dim == 128


def test_unported_features_raise():
    from repro.configs import mamba2_1_3b
    with pytest.raises(NotImplementedError):
        bridge.config_from_dict(dataclasses.asdict(mamba2_1_3b.make_smoke()))
    with pytest.raises(NotImplementedError):
        dataclasses.replace(t_sc2.make_smoke(), ring_cache=True)
    with pytest.raises(NotImplementedError):
        dataclasses.replace(t_sc2.make_smoke(),
                            quant=ttf.QuantPolicy(weights="int8"))


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, asking for the default device raises; it never runs
    on the CPU unless told to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_sc2.make_smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_lm(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_caches(cfg, 2, 8)
