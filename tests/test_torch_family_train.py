"""Training at the head dims of the families that train on the card at full
width, on the CPU: gemma3-27b's 168 and zamba2-7b's (and kimi-k2's) 112,
beside moonshot-v1-16b-a3b's aux loss.

Narrow configs keep each family's shape where it matters to the attention:
a gemma3-like model with one sliding-window layer and one global layer at
2 query heads on 1 KV head of 168 (gemma3's group of 2), a zamba2-like
model whose one shared attention block serves two sites at 2 heads of 112,
and moonshot's smoke config (MoE with its aux loss). The port's
``loss_fn`` takes the flash route there (``positions=None``: K6-K8's plain
versions on the CPU, the kernels on the card), and its loss and every
gradient leaf are held against ``jax.grad`` of the reference's
``loss_fn`` on the same weights, bridged array by array (the zamba2 model
on live ``conv_b``/``conv_c`` draws, as tests/test_torch_ssm_family.py
explains). Bounds: 2e-5 (tests/test_torch_train.py's). The JAX runs are
cached per module.

The depths chip_smoke.py trains the full-width configs at are reckoned
here on the ``meta`` device: 16 bytes a parameter (fp32 weight, gradient,
AdamW's two moments) must leave room on the card's 80 GB for a step's
activations.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models import transformer as ttf

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 20                        # S past the gemma3-like window of 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The narrow models' ops are far below any parallel grain: one torch
    thread while this file runs, the worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _gemma3_like():
    smoke = j_base.get("gemma3-27b").make_smoke()
    return dataclasses.replace(
        smoke, n_heads=2, n_kv_heads=1, head_dim=168,
        pattern=(jtf.BlockSpec(window=8), jtf.BlockSpec(window=-1)),
        repeats=1, tail=())


def _zamba2_like():
    return dataclasses.replace(j_base.get("zamba2-7b").make_smoke(),
                               n_heads=2, n_kv_heads=2, head_dim=112)


CONFIGS = {"gemma3-168": _gemma3_like, "zamba2-112": _zamba2_like,
           "moonshot-aux": lambda: j_base.get(
               "moonshot-v1-16b-a3b").make_smoke()}
_CACHE = {}


def _live(tree, seed=0):
    """``conv_b``/``conv_c`` of every ``ssd`` group drawn N(0, 0.2), in
    place, in the numpy tree (their init is zero, which silences the SSM
    state)."""
    rng = np.random.default_rng(seed)
    for k, v in sorted(tree.items()):
        if not isinstance(v, dict):
            continue
        if k == "ssd":
            for name in ("conv_b", "conv_c"):
                v[name] = rng.normal(0.0, 0.2, v[name].shape).astype(
                    v[name].dtype)
        else:
            _live(v, seed + 1)
    return tree


def _run(name):
    """(JAX cfg, port cfg, port params, batch as numpy, JAX loss, JAX aux,
    JAX gradient leaves by path) of ``name``'s config, cached."""
    if name in _CACHE:
        return _CACHE[name]
    jcfg = CONFIGS[name]()
    params = jax.jit(lambda k: jtf.init_lm(k, jcfg,
                                           dtype=jnp.float32).params)(
        jax.random.PRNGKey(0))
    tree = _live(jax.tree.map(np.asarray, params))
    tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_numpy(tree, tcfg, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, jbatch), has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    jflat = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    _CACHE[name] = (jcfg, tcfg, tparams, batch, float(jloss),
                    float(jaux["aux"]), jflat)
    return _CACHE[name]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, v


def _port_loss_and_grads(tcfg, tparams, batch):
    leaves, rebuild = common.flatten(tparams)
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    loss, aux = ttf.loss_fn(rebuild(leaves), tcfg, {
        k: torch.from_numpy(v).long() for k, v in batch.items()})
    grads = rebuild(list(torch.autograd.grad(loss, leaves)))
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_jax(name):
    """The port's loss (the aux loss in it) and every gradient leaf (the
    shared block's summed over its sites) within 2e-5 of ``jax.grad``'s on
    the same weights."""
    jcfg, tcfg, tparams, batch, jloss, jaux, jflat = _run(name)
    loss, aux, grads = _port_loss_and_grads(tcfg, tparams, batch)
    np.testing.assert_allclose(float(loss), jloss, **TOL)
    np.testing.assert_allclose(float(aux["aux"]), jaux, **TOL)
    tflat = dict(_flat(grads))
    assert tflat.keys() == jflat.keys()
    for k, w in jflat.items():
        np.testing.assert_allclose(tflat[k].numpy(), w, err_msg=k, **TOL)
    if name == "moonshot-aux":
        assert jaux > 0
    if name == "zamba2-112":
        assert np.abs(jflat["['pat0']['ssd']['conv_b']"]).max() > 0


# the flash-route attention layers a forward of each config runs, and the
# head dim they run at
FLASH_CALLS = {"gemma3-168": (2, 168), "zamba2-112": (2, 112),
               "moonshot-aux": (2, 16)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_training_takes_the_flash_route(name, monkeypatch):
    """Every attention layer of a training forward goes through
    ``ops.flash_attention_train`` (K6 forward, K7/K8 backward on the card)
    at the config's head dim, the windowed layer with its window: the
    route that on the card needs K6-K8 at 112 and 168."""
    _, tcfg, tparams, batch, *_ = _run(name)
    seen = []
    real = ops.flash_attention_train

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[2], kw["window"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention_train", spy)
    _port_loss_and_grads(tcfg, tparams, batch)
    n, d = FLASH_CALLS[name]
    assert len(seen) == n and {s[0] for s in seen} == {d}, seen
    if name == "gemma3-168":
        assert sorted(s[2] for s in seen) == [-1, 8]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# each full-width arch's training state on the card at chip_smoke.py's
# depth (16 bytes a parameter), its layers, and what the depth must cover
DEPTHS = {"gemma3-27b": (3.14e9, 4), "zamba2-7b": (1.10e9, 12),
          "moonshot-v1-16b-a3b": (1.47e9, 2), "mamba2-1.3b": (1.34e9, 48)}


@pytest.mark.parametrize("arch", list(DEPTHS))
def test_family_train_depths_fit_one_card(arch):
    """chip_smoke.py's ``family_train`` configs: full width, the depth the
    reckoning gives (within 2% of the parameters above), at most 60 GB of
    weights, gradients and AdamW moments (the rest of the 80 GB for a
    step's activations at B 1 x S 2048, mamba2's 48 layers at 1024);
    gemma3's with a sliding-window and a global layer past its window,
    zamba2's with two sites of its shared block."""
    cs = _chip_smoke()
    assert arch in cs.FAMILY_TRAIN
    cfg = cs._family_train_cfg(arch)
    full = j_base.get(arch).make_config()
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim) == (full.d_model, full.n_heads,
                                       full.n_kv_heads,
                                       full.resolved_head_dim)
    leaves, _ = common.flatten(ttf.init_lm(cfg, device="meta"))
    n = sum(t.numel() for t in leaves)
    want, layers = DEPTHS[arch]
    specs = tuple(cfg.pattern) * cfg.repeats + tuple(cfg.tail)
    assert len(specs) == layers
    assert abs(n - want) <= 0.02 * want, n
    assert 16 * n <= 60e9
    if arch == "gemma3-27b":
        assert {sp.window for sp in specs} == {1024, -1}
        assert cs.FAMILY_TRAIN[arch] > 1024
    if arch == "zamba2-7b":
        assert sum(sp.shared_attn for sp in specs) == 2


def test_ssd_gradients_finite_past_the_exp_range():
    """At full width a chunk of 256 steps sums its log-decay past fp32's
    exp range (~88); the masked entries of the intra-chunk decay then read
    exp(inf), whose gradient times the mask's zero is a NaN (the
    reference's ``where`` after the ``exp``, ssd.py:178, gives NaN
    gradients there: ``family_train`` found it in zamba2-7b's step). The
    port masks the exponent instead: the chunked scan's gradients are
    finite and equal the naive recurrence's."""
    from repro_torch.models import ssd as tssd
    rng = np.random.default_rng(0)
    b, s, h, p, n, chunk = 1, 256, 2, 4, 4, 256
    x, bm, cm = (rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, p), (b, s, h, n), (b, s, h, n)))
    dt = np.full((b, s, h), 0.5, np.float32)
    a = np.array([-1.0, -2.0], np.float32)
    assert float(-(dt[0, :, 0] * a[0]).sum()) > 88
    grads = []
    for fn in (lambda *t: tssd.ssd_chunked(*t, chunk), tssd.ssd_naive):
        xt = torch.tensor(x, requires_grad=True)
        dtt = torch.tensor(dt, requires_grad=True)
        y, final = fn(xt, dtt, torch.tensor(a), torch.tensor(bm),
                      torch.tensor(cm))
        (y.sum() + final.sum()).backward()
        grads.append((xt.grad, dtt.grad))
    for got, want in zip(*grads):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)
