"""The port's per-channel int8 quantizers and the cells' serving transform
(``repro_torch.quant.int8``) against ``repro.quant.int8`` on the same
arrays, on the CPU.

Bounds: ``quantize`` codes and scales equal bit for bit (both divide in
fp32 and round half to even), ``dequantize`` equal, ``quant_error``
within 1e-6 relative (the norms sum in different orders);
``quantize_params_for_serving`` on bridged smoke params of an LM with and
without stacked layers: every code and scale equal, the axes trees equal;
on meta tensors its leaves have the reference's ``ShapeDtypeStruct``
shapes and dtypes. ``quantize_stochastic`` draws other bits than
``jax.random``, so it is held to its distribution: every code the floor
or the ceiling of w / scale, and the mean of many draws within 4 standard
errors of w / scale.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_cfgbase
from repro.models import transformer as j_tf
from repro.quant import int8 as j_int8
from repro_torch import bridge
from repro_torch.models import transformer as t_tf
from repro_torch.quant import int8 as t_int8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_paths(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("axis", [-1, 0, 1])
@pytest.mark.parametrize("shape", [(64, 48), (3, 17, 5)])
def test_quantize_equals_reference(shape, axis):
    rng = np.random.default_rng(len(shape) * 10 + axis)
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0)
         ).astype(np.float32)
    w[0] = 0.0                                   # an all-zero slice too
    jw = j_int8.quantize(jnp.asarray(w), axis=axis)
    tw = t_int8.quantize(torch.from_numpy(w), axis=axis)
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    np.testing.assert_array_equal(
        t_int8.dequantize(tw, torch.float32).numpy(),
        np.asarray(j_int8.dequantize(jw, jnp.float32)))
    np.testing.assert_allclose(
        t_int8.quant_error(torch.from_numpy(w), tw),
        j_int8.quant_error(jnp.asarray(w), jw), rtol=1e-6)


def test_quantize_stochastic_distribution():
    """Codes are the floor or the ceiling of w / scale, and unbiased: the
    mean of 400 draws within 4 standard errors of w / scale (the codes'
    spread is at most 1/2 a draw)."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    det = t_int8.quantize(w)
    scaled = w / det.scale
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([t_int8.quantize_stochastic(w, generator=gen).q
                         for _ in range(400)]).float()
    lo, hi = torch.floor(scaled), torch.ceil(scaled)
    assert bool(((draws == lo) | (draws == hi)).all())
    mean = draws.mean(0)
    assert float((mean - scaled).abs().max()) < 4 * 0.5 / np.sqrt(400)
    np.testing.assert_array_equal(
        t_int8.quantize_stochastic(w, generator=gen).scale.numpy(),
        det.scale.numpy())
    # the seed fixes the draw
    a = t_int8.quantize_stochastic(w, generator=torch.Generator()
                                   .manual_seed(3)).q
    b = t_int8.quantize_stochastic(w, generator=torch.Generator()
                                   .manual_seed(3)).q
    assert torch.equal(a, b)


_PARAMS = {}


def _bridged(arch_id):
    """(JAX fp32 smoke params and axes, the port's bridged params, cfg)."""
    if arch_id not in _PARAMS:
        jcfg = j_cfgbase.get(arch_id).make_smoke()
        ax = j_tf.init_lm(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
        tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
        tp = bridge.params_from_numpy(jax.tree.map(np.asarray, ax.params),
                                      tcfg, device="cpu")
        _PARAMS[arch_id] = (ax, tp, jcfg, tcfg)
    return _PARAMS[arch_id]


@pytest.mark.parametrize("arch_id", ["starcoder2-7b", "gemma3-27b",
                                     "moonshot-v1-16b-a3b"])
def test_serving_transform_equals_reference(arch_id):
    ax, tp, jcfg, tcfg = _bridged(arch_id)
    jq, jq_axes = j_int8.quantize_params_for_serving(ax.params, ax.axes)
    tq, tq_axes = t_int8.quantize_params_for_serving(tp, t_tf.lm_axes(tcfg))
    assert _paths(tq_axes) == _paths(jq_axes)
    want, got = _paths(jq), _paths(tq)
    assert set(got) == set(want)
    n_q8 = 0
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(leaf),
                                      err_msg=str(path))
        assert got[path].dtype == getattr(torch, str(leaf.dtype))
        n_q8 += path[-1] == "q8"
    assert n_q8 > 0


@pytest.mark.parametrize("arch_id", ["starcoder2-7b", "kimi-k2-1t-a32b"])
def test_serving_transform_on_meta(arch_id):
    """Meta params (a full config) give meta leaves of the reference's
    ShapeDtypeStruct shapes and dtypes."""
    jcfg = j_cfgbase.get(arch_id).make_config()
    sds = jax.eval_shape(partial(j_tf.init_lm, cfg=jcfg),
                         jax.random.PRNGKey(0))
    jq, _ = j_int8.quantize_params_for_serving(sds.params, sds.axes)
    tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
    tq, _ = t_int8.quantize_params_for_serving(
        t_tf.init_lm(tcfg, device="meta"), t_tf.lm_axes(tcfg))
    want, got = _paths(jq), _paths(tq)
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].is_meta, path
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
