"""The dense family beyond starcoder2 on the port, against the JAX package
on the same bridged fp32 weights, on the CPU: gemma3-27b (head dim 24 in
its smoke config, 168 at full width; sliding-window layers of 8 beside
global ones, and ring caches), granite-34b (MQA), qwen1.5-110b (QKV bias,
an untied head, gated SiLU) and qwen2-vl-72b (M-RoPE and the stub vision
frontend), each at its smoke config.

Bounds: forward logits within 1e-4 (the bound tests/test_torch_transformer.py
holds starcoder2's to); greedy serve streams identical to the JAX
engine's, dense and paged (pages of 4, chunks of 8); prefill plus decode
within 1e-3 of the forward's last logits (tests/test_models_smoke.py's
bound) and within 1e-4 of JAX's decode logits. The JAX runs are cached per
module, so each model is built and each JAX engine drained once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import base as t_base
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.serve import ServeConfig, ServeEngine


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This file's ops are far below any parallel grain, but on a loaded
    host (the suite's parallel workers) idle intra-op threads cost it
    several times its run time: one torch thread while it runs, the
    worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCHS = ("gemma3-27b", "granite-34b", "qwen1.5-110b", "qwen2-vl-72b")
MAX_LEN = 40
# gemma3-smoke's local window is 8: most prompts run past it
PROMPT_LENS = (5, 13, 3, 19, 11, 1)
NEW = 6
_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _models(arch, **changes):
    """(JAX cfg, JAX params, port cfg, port params) of ``arch``'s smoke
    config with ``changes``, bridged array by array."""
    def make():
        jcfg = dataclasses.replace(j_base.get(arch).make_smoke(), **changes)
        params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                             dtype=jnp.float32).params
        tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           tcfg, device="cpu")
        return jcfg, params, tcfg, tparams
    return _cached(("models", arch, tuple(sorted(changes.items()))), make)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def _drain(eng, prompts):
    for p in prompts:
        eng.submit(p, max_tokens=NEW)
    return {r.uid: r.generated for r in eng.run_until_drained()}


def _paged(**kw):
    return dict(paged=True, page_size=4, prefill_chunk=8, **kw)


def _jax_streams(arch, mode, **changes):
    def make():
        jcfg, params, _, _ = _models(arch, **changes)
        kw = _paged() if mode == "paged" else {}
        return _drain(JServeEngine(params, jcfg, JServeConfig(
            max_slots=2, max_len=MAX_LEN, **kw)), _prompts(jcfg.vocab))
    return _cached(("jax", arch, mode, tuple(sorted(changes.items()))), make)


def _port_streams(arch, mode, **changes):
    _, _, tcfg, tparams = _models(arch, **changes)
    kw = _paged() if mode == "paged" else {}
    return _drain(ServeEngine(tparams, tcfg, ServeConfig(
        device="cpu", max_slots=2, max_len=MAX_LEN, **kw)),
        _prompts(tcfg.vocab))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_mirror_the_reference(arch):
    """The port's registry holds the arch, and its configs are the
    reference's, full size and smoke, through the bridge."""
    spec = j_base.get(arch)
    for make, t_make in ((spec.make_config, t_base.get(arch).make_config),
                         (spec.make_smoke, t_base.get(arch).make_smoke)):
        assert bridge.config_from_dict(dataclasses.asdict(make())) == t_make()
    full = t_base.get(arch).make_config()
    assert full.resolved_head_dim == {"gemma3-27b": 168}.get(arch, 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_match(arch):
    """Every leaf of the JAX tree (gemma3's six stacked pattern groups and
    tail, qwen's biases and untied head) with the port's shape and
    dtype."""
    jcfg, params, tcfg, _ = _models(arch)
    tp = ttf.init_lm(tcfg, seed=0, dtype=torch.float32, device="cpu")
    want = {jax.tree_util.keystr(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", tuple(v.shape)

    assert dict(walk(tp)) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch):
    jcfg, params, tcfg, tparams = _models(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 20))
    want, _ = jtf.forward(params, jcfg, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, _ = ttf.forward(tparams, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("mode", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_jax_engine(arch, mode):
    """Six prompts of 1-19 tokens on two slots, six tokens each."""
    got = _port_streams(arch, mode)
    assert got == _jax_streams(arch, mode)
    assert all(len(s) == NEW for s in got.values())


def test_gemma3_prompts_run_past_the_window():
    _, _, tcfg, _ = _models("gemma3-27b")
    windows = {sp.window for sp in tcfg.pattern + tcfg.tail}
    assert windows == {8, -1}
    assert sum(n > 8 for n in PROMPT_LENS) >= 3


def test_gemma3_prefill_then_decode_equals_forward():
    """tests/test_models_smoke.py::test_lm_smoke_decode on the port: a
    6-token prefill and 6 decode steps (the window of 8 bites from
    position 8) give the forward's last logits, and JAX's decode logits."""
    jcfg, params, tcfg, tparams = _models("gemma3-27b")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (1, 12))
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        full, _ = ttf.forward(tparams, tcfg, tt)
        _, caches = ttf.prefill(tparams, tcfg, tt[:, :6], max_len=12,
                                cache_dtype=torch.float32)
        for t in range(6, 12):
            last, caches = ttf.decode_step(tparams, tcfg, tt[:, t:t + 1],
                                           torch.tensor(t), caches)
    np.testing.assert_allclose(last[:, 0].numpy(),
                               full[:, -1, :tcfg.vocab].numpy(), atol=1e-3)
    jt = jnp.asarray(toks, jnp.int32)
    _, jc = jtf.prefill(params, jcfg, jt[:, :6], max_len=12,
                        cache_dtype=jnp.float32)
    for t in range(6, 12):
        jlast, jc = jtf.decode_step(params, jcfg, jt[:, t:t + 1],
                                    jnp.asarray(t), jc)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4)


def test_gemma3_ring_cache_dense_streams_match_jax():
    """``ring_cache=True``: the local layers keep window-sized rings, the
    dense engine decodes through the tag-masked sdpa, as JAX's does."""
    _, _, tcfg, _ = _models("gemma3-27b", ring_cache=True)
    caches = ttf.init_caches(tcfg, 2, MAX_LEN, torch.float32, device="cpu")
    assert caches["pat0"]["kv"].k.shape[2] == 8          # local: the window
    assert caches["pat2"]["kv"].k.shape[2] == MAX_LEN    # global
    assert not ttf.paged_supported(tcfg)
    got = _port_streams("gemma3-27b", "dense", ring_cache=True)
    assert got == _jax_streams("gemma3-27b", "dense", ring_cache=True)
    assert all(len(s) == NEW for s in got.values())


def test_gemma3_ring_prefill_caches_match_jax():
    """A prompt longer than the ring (and a padded row) fills the rings by
    the reference's ring branch: the last positions at ``pos % clen``, the
    tags past a row's length -1; then two decode steps at per-slot
    positions write the rings in place."""
    jcfg, params, tcfg, tparams = _models("gemma3-27b", ring_cache=True)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 13))
    lens = np.array([13, 10], np.int32)
    lj, jc = jtf.prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                         max_len=20, cache_dtype=jnp.float32,
                         lengths=jnp.asarray(lens))
    with torch.no_grad():
        lt, tc = ttf.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                             max_len=20, cache_dtype=torch.float32,
                             lengths=torch.from_numpy(lens).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    pos = lens.copy()
    tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)[:, None]
    for _ in range(2):
        lj, jc = jtf.decode_step(params, jcfg, jnp.asarray(tok),
                                 jnp.asarray(pos), jc)
        with torch.no_grad():
            lt, tc = ttf.decode_step(tparams, tcfg,
                                     torch.from_numpy(tok).long(),
                                     torch.from_numpy(pos).long(), tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)[:, None]
        pos = pos + 1
    for key, entry in jc.items():
        np.testing.assert_allclose(tc[key]["kv"].k.numpy(),
                                   np.asarray(entry["kv"].k), atol=1e-5)
        np.testing.assert_array_equal(tc[key]["pos"].numpy(),
                                      np.asarray(entry["pos"]))


def test_apply_mrope_matches_jax():
    """Three position streams over sections (2, 3, 3) of the half head
    dim 8, and a section sum that misses it raises."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 7, 3)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (2, 3, 3),
                               1e6)
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                              (2, 3, 3), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="sections"):
        tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                            (2, 3, 2))


def test_qwen2vl_forward_with_vision_embeds_and_mrope_positions():
    """The stub frontend's patch embeddings over the first 4 tokens, and
    (B, S, 3) positions that differ per stream; the logits of the first
    positions move with the embeddings."""
    jcfg, params, tcfg, tparams = _models("qwen2-vl-72b")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    vis = rng.standard_normal((2, jcfg.vision_tokens,
                               jcfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 12, (2, 12, 3)).astype(np.int32)
    want, _ = jtf.forward(params, jcfg, jnp.asarray(toks),
                          positions=jnp.asarray(pos),
                          vision_embeds=jnp.asarray(vis))
    with torch.no_grad():
        got, _ = ttf.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                             positions=torch.from_numpy(pos).long(),
                             vision_embeds=torch.from_numpy(vis))
        plain, _ = ttf.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                               positions=torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert np.abs(got.numpy()[:, 0] - plain.numpy()[:, 0]).max() > 1e-3
