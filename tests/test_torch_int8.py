"""The port's int8 serving fast path (int8 weights through K4's plain
version, int8 KV caches through the int8-KV plain versions of K1, K2 and
K3) against the JAX package on the same numpy inputs and bridged fp32
weights, on the CPU.

On the CPU the port's kernels run their plain versions (``kernels/ref.py``);
chip_smoke.py holds the CUDA kernels against those on the card. Bounds:

* quantizers: bit-identical codes and scales (``torch.round`` and
  ``jnp.round`` both round half to even);
* K4's plain version and ``layers.q8_matmul`` against the Pallas kernel in
  interpret mode: 1e-5 relative to the output's largest magnitude;
* the int8-KV plain versions of K1, K2 and K3 against the Pallas kernels
  in interpret mode: 1e-5 on live rows, exact zeros on dead ones;
* model functions under ``INT8_QUANT``: logits within 1e-4. int8 caches
  are compared dequantized, within one scale step of their row; a code
  may differ from JAX's only by one, where the two sides' fp32 K/V, which
  differ by ~1e-7, fall on opposite sides of a rounding tie. On these
  inputs 0 of the 59,904 dense and 0 of the 73,728 paged codes differed
  (the reference's own contiguous-int8 extend test flips one);
* engines: identical greedy streams against the JAX int8 engine at
  ``decode_kernel=False`` and ``True``, and per-tick bills equal to 1e-9
  relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import moonshot_v1_16b_a3b as j_moonshot
from repro.configs import starcoder2_7b as j_sc2
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.quant import int8 as jq
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import token_agreement as j_token_agreement
from repro_torch import bridge
from repro_torch.kernels import int8_matmul as k4
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models import transformer as ttf
from repro_torch.quant import int8 as tq
from repro_torch.serve import (ReferenceEngine, ServeConfig, ServeEngine,
                               StepMetrics, token_agreement)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The smoke models' and plain kernels' ops are far below any
    parallel grain, but on a loaded host (the suite's parallel workers)
    idle intra-op threads cost this file many times its run time: one
    thread while it runs, the worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _core_cfg():
    """tests/test_serve_quant.py::_cfg."""
    return jtf.LMConfig(name="t", d_model=48, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=61, pattern=(jtf.BlockSpec(),),
                        repeats=2, remat="none", vocab_pad_multiple=1)


CFGS = {"starcoder2-smoke": j_sc2.make_smoke, "serve-core": _core_cfg}
# the trees quantize_lm is held to: an MoE block's experts add a lead dim
QUANT_CFGS = dict(CFGS, **{"moonshot-smoke": j_moonshot.make_smoke})
_CACHE = {}


def _models(name):
    """(JAX cfg, JAX fp32 params, port cfg, port fp32 params)."""
    if name not in _CACHE:
        jcfg = QUANT_CFGS[name]()
        params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                             dtype=jnp.float32).params
        tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
        tparams = bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        _CACHE[name] = (jcfg, params, tcfg, tparams)
    return _CACHE[name]


def _qmodels(name):
    """The same models quantized: JAX's quantize_lm output, bridged."""
    key = ("q", name)
    if key not in _CACHE:
        jcfg, params, tcfg, _ = _models(name)
        jq_params = jtf.quantize_lm(params)
        jq_cfg = dataclasses.replace(jcfg, quant=jtf.INT8_QUANT)
        tq_cfg = bridge.config_from_dict(dataclasses.asdict(jq_cfg))
        tq_params = bridge.params_from_numpy(
            jax.tree.map(np.asarray, jq_params), tq_cfg, device="cpu")
        _CACHE[key] = (jq_cfg, jq_params, tq_cfg, tq_params)
    return _CACHE[key]


def _t(a):
    return torch.from_numpy(np.array(a))


# -----------------------------------------------------------------------------
# Quantizers: bit-identical to JAX's
# -----------------------------------------------------------------------------

def _with_zero_channel(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0                     # an all-zero channel: the scale floor
    return w


@pytest.mark.parametrize("shape,axis", [((3, 5, 2, 16), -1), ((7, 9), 0),
                                        ((4, 6), -1)])
def test_quantize_rowwise_bit_identical(shape, axis):
    x = _with_zero_channel(np.random.default_rng(0), shape)
    x[0] = 0.0                          # and an all-zero row
    jq_, js = jq.quantize_rowwise(jnp.asarray(x), axis=axis)
    tq_, ts = tq.quantize_rowwise(_t(x), axis=axis)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_rowwise(tq_, ts, axis=axis).numpy(),
        np.asarray(jq.dequantize_rowwise(jq_, js, axis=axis)))


@pytest.mark.parametrize("shape,lead,out_dims", [((6, 10), 0, 1),
                                                 ((3, 8, 2, 4), 1, 2),
                                                 ((2, 2, 4, 6), 1, 1)])
def test_quantize_weight_bit_identical(shape, lead, out_dims):
    w = _with_zero_channel(np.random.default_rng(1), shape)
    want = jq.quantize_weight(jnp.asarray(w), lead=lead, out_dims=out_dims)
    got = tq.quantize_weight(_t(w), lead=lead, out_dims=out_dims)
    for key in ("q8", "s8"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


@pytest.mark.parametrize("name", sorted(QUANT_CFGS))
def test_quantize_lm_bit_identical(name):
    """The port's quantize_lm on bridged fp32 weights equals JAX's on the
    originals, leaf for leaf (stacked leaves keep per-layer scales, and an
    MoE block's experts one scale row each; its router stays fp32)."""
    tparams = _models(name)[3]
    # JAX's quantize_lm of the same params, computed once per module
    want = jax.tree.map(np.asarray, _qmodels(name)[1])
    got = ttf.quantize_lm(tparams)

    def walk(w, g, path):
        assert set(w) == set(g), path
        for k in w:
            if isinstance(w[k], dict):
                walk(w[k], g[k], path + (k,))
            else:
                assert g[k].dtype == bridge._to_tensor(w[k], "cpu").dtype
                np.testing.assert_array_equal(g[k].numpy(), w[k],
                                              err_msg=str(path + (k,)))

    walk(want, got, ())
    tcfg = _models(name)[2]
    assert got["pat0"]["attn"]["wq"]["s8"].shape[0] == tcfg.repeats
    if tcfg.moe_cfg is not None:
        moe = got["pat0"]["moe"]
        assert tuple(moe["w_in"]["s8"].shape) == (
            tcfg.repeats, tcfg.moe_cfg.n_experts, 1, tcfg.moe_cfg.d_ff)
        assert moe["router"].dtype == torch.float32


def test_quantize_lm_passes_a_quantized_tree_through():
    tparams = _qmodels("serve-core")[3]
    again = ttf.quantize_lm(tparams)
    assert again["pat0"]["mlp"]["w_in"] is tparams["pat0"]["mlp"]["w_in"]


# -----------------------------------------------------------------------------
# K4: the plain version and q8_matmul against the Pallas kernel
# -----------------------------------------------------------------------------

def _rel_close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per-channel", "scalar"])
@pytest.mark.parametrize("m,k,n", [(1, 48, 13), (5, 96, 130), (37, 16, 7),
                                   (3, 528, 9)])
def test_int8_matmul_plain_matches_pallas(m, k, n, per_channel):
    """Ragged M, N and K (K = 528 spans two of the Pallas kernel's K
    blocks), and the scale shapes repro.kernels.ops.int8_matmul takes."""
    rng = np.random.default_rng(m * 1000 + n)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.random((1, n)) * 0.05 + 1e-3).astype(np.float32) \
        if per_channel else np.float32(0.02)
    want = np.asarray(jops.int8_matmul(jnp.asarray(x), jnp.asarray(q),
                                       jnp.asarray(scale), interpret=True))
    got = ops.int8_matmul(_t(x), _t(q), _t(scale)).numpy()
    assert got.shape == (2, m, n) and got.dtype == np.float32
    _rel_close(got, want)


@pytest.mark.parametrize("leaf,contract", [("wq", 1), ("wo", 2),
                                           ("w_in", 1)])
def test_q8_matmul_matches_jax(leaf, contract):
    """layers.q8_matmul on one layer's quantized leaf of the starcoder2
    smoke model, against JAX's (its Pallas kernel in interpret mode)."""
    _, jqp, _, tqp = _qmodels("starcoder2-smoke")
    group = "mlp" if leaf == "w_in" else "attn"
    jw = jax.tree.map(lambda a: a[0], jqp["pat0"][group][leaf])
    tw = {k: v[0] for k, v in tqp["pat0"][group][leaf].items()}
    kshape = jw["q8"].shape[:contract]
    x = np.random.default_rng(2).standard_normal(
        (2, 3) + tuple(kshape)).astype(np.float32)
    want = np.asarray(jlayers.q8_matmul(jnp.asarray(x), jw, contract))
    got = layers.q8_matmul(_t(x), tw, contract).numpy()
    assert got.shape == want.shape
    _rel_close(got, want)


def test_int8_matmul_cpu_path_does_not_touch_the_kernel():
    before = k4.int8_matmul.launches
    ops.int8_matmul(torch.ones(2, 16), torch.ones(16, 3, dtype=torch.int8),
                    torch.ones(3))
    assert k4.int8_matmul.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        k4.int8_matmul(torch.ones(2, 16), torch.ones(16, 3, dtype=torch.int8),
                       torch.ones(3))


# -----------------------------------------------------------------------------
# The int8-KV modes of K1, K2 and K3: plain versions against Pallas
# -----------------------------------------------------------------------------

def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _scales(rng, shape):
    return (rng.random(shape) * 0.05 + 1e-3).astype(np.float32)


@pytest.mark.parametrize("window", [-1, 6])
@pytest.mark.parametrize("rep,d", [(1, 16), (9, 128)])
def test_int8_kv_decode_plain_matches_pallas(rep, d, window):
    rng = np.random.default_rng(4)
    b, sk, hkv = 4, 40, 2
    q = rng.standard_normal((b, hkv * rep, d)).astype(np.float32)
    k, v = _codes(rng, (b, sk, hkv, d)), _codes(rng, (b, sk, hkv, d))
    ks, vs = _scales(rng, (b, sk, hkv)), _scales(rng, (b, sk, hkv))
    lens = np.array([40, 0, 1, 17], np.int32)
    scale = d ** -0.5
    args = (q, k, v, lens)
    got = ops.decode_attention(*map(_t, args), scale=scale, window=window,
                               k_scale=_t(ks), v_scale=_t(vs)).numpy()
    want = np.asarray(jops.decode_attention(
        *map(jnp.asarray, args), scale=scale, window=window,
        interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    live = lens > 0
    assert np.abs(got[live] - want[live]).max() < 1e-5
    assert (got[~live] == 0.0).all() and (want[~live] == 0.0).all()


@pytest.mark.parametrize("window", [-1, 6])
def test_int8_kv_paged_decode_plain_matches_pallas(window):
    rng = np.random.default_rng(5)
    b, ps, nb, hkv, d, npages, rep = 5, 8, 4, 2, 16, 24, 3
    q = rng.standard_normal((b, hkv * rep, d)).astype(np.float32)
    kp, vp = (_codes(rng, (npages + 1, ps, hkv, d)) for _ in range(2))
    ks, vs = (_scales(rng, (npages + 1, ps, hkv)) for _ in range(2))
    pt = rng.permutation(npages)[:b * nb].reshape(b, nb).astype(np.int32)
    lens = np.array([24, 10, 0, 1, 32], np.int32)
    args = (q, kp, vp, pt, lens)
    got = ops.paged_decode_attention(*map(_t, args), scale=0.25,
                                     window=window, k_scale=_t(ks),
                                     v_scale=_t(vs)).numpy()
    want = np.asarray(jops.paged_decode_attention(
        *map(jnp.asarray, args), scale=0.25, window=window, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    live = lens > 0
    assert np.abs(got[live] - want[live]).max() < 1e-5
    assert (got[~live] == 0.0).all() and (want[~live] == 0.0).all()


@pytest.mark.parametrize("window", [-1, 6])
def test_int8_kv_paged_prefill_plain_matches_pallas(window):
    """The cached prefix in int8 with its scales, the chunk's own K/V in
    q's dtype; an unaligned start, a short row and a dead row."""
    b, c, h, hkv, d, ps, npages, nbk = 3, 5, 4, 2, 8, 4, 16, 4
    rng = np.random.default_rng(6)
    q = rng.normal(size=(b, c, h, d)).astype(np.float32)
    k_new = rng.normal(size=(b, c, hkv, d)).astype(np.float32)
    v_new = rng.normal(size=(b, c, hkv, d)).astype(np.float32)
    kp, vp = (_codes(rng, (npages, ps, hkv, d)) for _ in range(2))
    ks, vs = (_scales(rng, (npages, ps, hkv)) for _ in range(2))
    pt = rng.permutation(npages)[:b * nbk].reshape(b, nbk).astype(np.int32)
    starts = np.array([13, 4, 0], np.int32)
    lens = np.array([5, 3, 0], np.int32)
    args = (q, k_new, v_new, kp, vp, pt, starts, lens)
    got = ops.paged_prefill_attention(*map(_t, args), scale=d ** -0.5,
                                      window=window, k_scale=_t(ks),
                                      v_scale=_t(vs)).numpy()
    want = np.asarray(jops.paged_prefill_attention(
        *map(jnp.asarray, args), scale=d ** -0.5, window=window,
        interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    # every lane of a live row, the padding lanes past its length too
    live = lens > 0
    assert np.abs(got[live] - want[live]).max() < 1e-5
    assert (got[~live] == 0.0).all() and (want[2] == 0.0).all()


# -----------------------------------------------------------------------------
# Model functions under INT8_QUANT against JAX's
# -----------------------------------------------------------------------------

def _compare_int8_caches(jc, tc, skip_page=None):
    """Dequantized K/V within one scale step of their row; differing codes
    only by one (a rounding tie). Returns the number of differing codes."""
    flipped = 0
    for key, entry in jc.items():
        ax = 1 if key.startswith("pat") else 0
        for name in ("k", "v"):
            jcodes = np.asarray(getattr(entry["kv"], name)).astype(np.int32)
            jsc = np.asarray(getattr(entry["kv_scale"], name))
            tcodes = getattr(tc[key]["kv"], name).numpy().astype(np.int32)
            tsc = getattr(tc[key]["kv_scale"], name).numpy()
            if skip_page is not None:
                jcodes, tcodes, jsc, tsc = (np.delete(a, skip_page, axis=ax)
                                            for a in (jcodes, tcodes, jsc,
                                                      tsc))
            np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-12)
            deq_j = jcodes * jsc[..., None]
            deq_t = tcodes * tsc[..., None]
            step = np.maximum(jsc, tsc)[..., None]
            assert (np.abs(deq_t - deq_j) <= step * (1 + 1e-5)).all(), key
            diff = np.abs(tcodes - jcodes)
            assert diff.max() <= 1, key
            flipped += int((diff > 0).sum())
    return flipped


@pytest.mark.parametrize("name", sorted(CFGS))
def test_prefill_and_decode_step_int8_match_jax(name):
    """Padded two-row prefill into int8 caches, then three batched decode
    steps (the port's K1 plain version, JAX's XLA dequant path) and one
    scalar-position step (both dequantize and run sdpa)."""
    jcfg, jqp, tcfg, tqp = _qmodels(name)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    lens = np.array([8, 5], np.int32)
    max_len = 16
    lj, jc = jtf.prefill(jqp, jcfg, jnp.asarray(toks), max_len=max_len,
                         cache_dtype=jnp.float32, lengths=jnp.asarray(lens))
    lt, tc = ttf.prefill(tqp, tcfg, _t(toks).long(), max_len=max_len,
                         cache_dtype=torch.float32, lengths=_t(lens).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    assert tc["pat0"]["kv"].k.dtype == torch.int8
    flipped = _compare_int8_caches(jc, tc)
    pos = lens.astype(np.int32)
    tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)
    for _ in range(3):
        lj, jc = jtf.decode_step(jqp, jcfg, jnp.asarray(tok[:, None]),
                                 jnp.asarray(pos), jc)
        lt, tc = ttf.decode_step(tqp, tcfg, _t(tok[:, None]).long(),
                                 _t(pos).long(), tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        flipped += _compare_int8_caches(jc, tc)
        tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)
        pos = pos + 1
    # scalar position: every row at the same position
    p0 = int(pos.max())
    lj, jc = jtf.decode_step(jqp, jcfg, jnp.asarray(tok[:, None]),
                             jnp.asarray(p0), jc)
    lt, tc = ttf.decode_step(tqp, tcfg, _t(tok[:, None]).long(),
                             torch.tensor(p0), tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    flipped += _compare_int8_caches(jc, tc)
    assert flipped == 0


NPAGES, PS, NSLOTS, NBLK = 16, 4, 2, 8


@pytest.mark.parametrize("name", sorted(CFGS))
def test_paged_extend_and_decode_step_int8_match_jax(name):
    """Two ragged extend chunks (the second with a dead row) into int8
    pools through a fragmented table, then three decode ticks with one
    lane inactive (its writes go to the sink page, left out of the
    comparison)."""
    jcfg, jqp, tcfg, tqp = _qmodels(name)
    jcfg = dataclasses.replace(jcfg, decode_kernel=False)
    jc = jtf.init_paged_caches(jcfg, NPAGES, PS, dtype=jnp.float32)
    tc = ttf.init_paged_caches(tcfg, NPAGES, PS, dtype=torch.float32,
                               device="cpu")
    assert "kv_scale" in tc["pat0"] and tc["pat0"]["kv"].k.dtype == torch.int8
    rng = np.random.default_rng(3)
    pt = rng.permutation(NPAGES)[:NSLOTS * NBLK].reshape(
        NSLOTS, NBLK).astype(np.int32)
    starts = np.zeros(NSLOTS, np.int32)
    flipped = 0
    for chunk in ((7, 5), (6, 0)):
        lens = np.asarray(chunk, np.int32)
        toks = rng.integers(0, jcfg.vocab, (NSLOTS, 8)).astype(np.int32)
        lj, jc = jtf.paged_extend(jqp, jcfg, jnp.asarray(toks),
                                  jnp.asarray(starts), jnp.asarray(lens),
                                  jnp.asarray(pt), jc)
        lt, tc = ttf.paged_extend(tqp, tcfg, _t(toks).long(),
                                  _t(starts).long(), _t(lens).long(),
                                  _t(pt), tc)
        live = lens > 0
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live],
                                   atol=1e-4)
        flipped += _compare_int8_caches(jc, tc, skip_page=NPAGES)
        starts = starts + lens
    tok = rng.integers(0, jcfg.vocab, NSLOTS).astype(np.int32)
    pos = starts.copy()
    active = np.array([True, False])
    for _ in range(3):
        lj, jc = jtf.paged_decode_step(jqp, jcfg, jnp.asarray(tok[:, None]),
                                       jnp.asarray(pos), jnp.asarray(pt), jc,
                                       active=jnp.asarray(active))
        lt, tc = ttf.paged_decode_step(tqp, tcfg, _t(tok[:, None]).long(),
                                       _t(pos).long(), _t(pt), tc,
                                       active=_t(active))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        flipped += _compare_int8_caches(jc, tc, skip_page=NPAGES)
        tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)
        pos = pos + active
    assert flipped == 0


def test_move_pages_moves_int8_scale_pools():
    """move_pages copies the code pools and the scale pools alike, the
    gather first (page 5 is a source and a destination)."""
    _, _, tcfg, _ = _qmodels("serve-core")
    tc = ttf.init_paged_caches(tcfg, NPAGES, PS, device="cpu")
    g = torch.Generator().manual_seed(0)
    before = {}
    for key, entry in tc.items():
        for pair in ("kv", "kv_scale"):
            for n in ("k", "v"):
                t = getattr(entry[pair], n)
                t.copy_(torch.randint(-127, 128, t.shape, generator=g))
                before[key, pair, n] = t.clone()
    ttf.move_pages(tc, torch.tensor([3, 5]), torch.tensor([5, 9]))
    for (key, pair, n), old in before.items():
        new = getattr(tc[key][pair], n)
        assert torch.equal(new[:, 9], old[:, 5])
        assert torch.equal(new[:, 5], old[:, 3])
        assert torch.equal(new[:, 3], old[:, 3])


# -----------------------------------------------------------------------------
# The int8 engines against the JAX int8 engine
# -----------------------------------------------------------------------------

RAGGED = [np.arange(30), np.arange(3) + 7, np.arange(21) + 2,
          np.arange(9) + 40]
BILLED = [f.name for f in dataclasses.fields(StepMetrics)
          if f.name != "wall_s"]


def _drain(eng, prompts, max_tokens):
    for p in prompts:
        eng.submit(np.asarray(p, np.int32), max_tokens=max_tokens)
    return {r.uid: list(r.generated) for r in eng.run_until_drained()}


def _assert_bills_equal(je, te):
    assert len(je.metrics_log) == len(te.metrics_log)
    for tick, (jm, tm) in enumerate(zip(je.metrics_log, te.metrics_log)):
        for f in BILLED:
            assert getattr(tm, f) == pytest.approx(getattr(jm, f), rel=1e-9,
                                                   abs=0.0), (tick, f)


_PAGED = dict(paged=True, page_size=4, prefill_chunk=8)


@pytest.mark.parametrize("kernel", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_int8_engine_matches_jax(name, paged, kernel):
    """Greedy streams of the port's int8 engine (fp32 weights quantized at
    construction) equal the JAX int8 engine's, on its XLA path and on its
    Pallas path (interpret mode), with the same per-tick bills. The port's
    kernel-path gather bill is switched on beside JAX's Pallas path."""
    jcfg, params, tcfg, tparams = _models(name)
    kw = dict(max_slots=2, max_len=48, quant="int8",
              **(_PAGED if paged else {}))
    je = JServeEngine(params, jcfg, JServeConfig(decode_kernel=kernel, **kw))
    te = ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw))
    te._kernel_path = kernel
    prompts, n = (RAGGED, 5) if name == "serve-core" else (RAGGED[:3], 4)
    want = _drain(je, prompts, n)
    assert _drain(te, prompts, n) == want
    assert all(len(s) == n for s in want.values())
    _assert_bills_equal(je, te)
    assert te.weight_bytes == je.weight_bytes
    assert te.kv_cache_bytes == je.kv_cache_bytes
    if paged:
        assert te.pool.state_dict() == je.pool.state_dict()


def test_int8_engine_caches_and_bytes():
    """int8 codes plus fp32 scales in the cache and the pool; at least 1.5x
    fewer resident KV bytes than bf16 and over 2x fewer weight bytes than
    the fp32 tree, as tests/test_serve_quant.py holds the JAX engine."""
    tcfg, tparams = _models("serve-core")[2:]
    for extra in ({}, _PAGED):
        q = ServeEngine(tparams, tcfg, ServeConfig(
            max_slots=2, max_len=32, quant="int8", device="cpu", **extra))
        bf16 = ServeEngine(tparams, tcfg, ServeConfig(
            max_slots=2, max_len=32, cache_dtype=torch.bfloat16,
            device="cpu", **extra))
        entry = q.state.caches["pat0"]
        assert entry["kv"].k.dtype == torch.int8
        assert entry["kv_scale"].k.dtype == torch.float32
        assert q.cfg.quant == ttf.INT8_QUANT
        assert bf16.kv_cache_bytes / q.kv_cache_bytes >= 1.5
        assert bf16.weight_bytes / q.weight_bytes > 2.0


def test_int8_reference_engine_matches_engine():
    """The host-loop oracle, given the int8 engine's params and cfg, runs
    the int8 mode (K4's plain version, dequantize + sdpa) and is
    token-identical to the engine (K1's int8 plain version)."""
    tcfg, tparams = _models("starcoder2-smoke")[2:]
    scfg = ServeConfig(max_slots=2, max_len=48, quant="int8", device="cpu")
    eng = ServeEngine(tparams, tcfg, scfg)
    ref = ReferenceEngine(eng.params, eng.cfg, scfg)
    assert ref.caches["pat0"]["kv"].k.dtype == torch.int8
    assert _drain(eng, RAGGED, 5) == _drain(ref, RAGGED, 5)


def test_token_agreement_matches_jax():
    jcfg, params, tcfg, tparams = _models("serve-core")
    prompts = np.random.default_rng(0).integers(0, 61, size=(4, 8))
    want = j_token_agreement(params, jcfg, prompts, n_tokens=6)
    got = token_agreement(tparams, tcfg, prompts, n_tokens=6)
    assert got["agreement"] == want["agreement"]
    assert got["tokens"] == want["tokens"] == 24
    assert got["max_logit_gap"] == pytest.approx(want["max_logit_gap"],
                                                 abs=1e-4)


def test_int8_forced_compaction_matches_jax():
    """Scattered pages and a low threshold: both int8 engines move the
    same pages (codes and scales) on the same ticks and their streams stay
    the same."""
    jcfg, params, tcfg, tparams = _models("serve-core")
    kw = dict(max_slots=2, max_len=64, paged=True, page_size=4,
              prefill_chunk=8, num_pages=24, compact_threshold=0.05,
              quant="int8")
    je = JServeEngine(params, jcfg, JServeConfig(decode_kernel=False, **kw))
    te = ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw))
    for eng in (je, te):
        rs = np.random.default_rng(5)
        eng.pool._free = [int(p) for p in rs.permutation(eng.pool._free)]
    prompts = [np.arange(n) % 50 for n in (29, 17, 25, 9)]
    want = _drain(je, prompts, 6)
    assert _drain(te, prompts, 6) == want
    _assert_bills_equal(je, te)
    assert sum(m.compaction_moves for m in te.metrics_log) > 0
    assert te.pool.live == 0


def test_launcher_serves_int8_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    for extra in ([], ["--paged", "--page-size", "4", "--prefill-chunk",
                       "8"]):
        launch.main(["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
                     "--requests", "3", "--max-tokens", "3", "--slots", "2",
                     "--quant", "int8"] + extra)
        out = capsys.readouterr().out
        assert out.count("req ") == 3 and '"bytes_moved"' in out


def test_unknown_quant_modes_raise():
    tcfg, tparams = _models("serve-core")[2:]
    with pytest.raises(ValueError, match="quant"):
        ServeEngine(tparams, tcfg, ServeConfig(quant="fp4", device="cpu"))
    with pytest.raises(SystemExit):
        from repro_torch.launch import serve as launch
        launch.main(["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
                     "--quant", "fp4"])


@pytest.mark.parametrize("op", ["decode", "paged_decode", "paged_prefill"])
def test_int8_kv_scales_come_in_pairs(op):
    x = torch.zeros((1, 1, 2, 16))
    sc = torch.ones((1, 1, 2))
    i = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="both KV scales"):
        if op == "decode":
            ops.decode_attention(x[:, 0], x, x, i, k_scale=sc)
        elif op == "paged_decode":
            ops.paged_decode_attention(x[:, 0], x, x, i[None], i, v_scale=sc)
        else:
            ops.paged_prefill_attention(x, x, x, x, x, i[None], i, i,
                                        k_scale=sc)


@pytest.mark.parametrize("k,n", [(4608, 4608), (4608, 512), (4608, 18432),
                                 (18432, 4608), (48, 13), (18432, 18432)])
def test_int8_matmul_decode_split_policy(k, n):
    """The decode kernel's plan: each 128-column tile's 128-row rounds in
    equal bands of at least 4 rounds (or one band), as many as divide the
    rounds with every block resident (2 an SM of an H100's 132), one block
    a (tile, band), every round of every tile in exactly one block."""
    pl = k4.decode_plan(k, n, 132)
    assert (pl.tiles, pl.rounds) == (-(-n // 128), -(-k // 128))
    assert pl.rounds % pl.bands == 0 and pl.blocks == pl.tiles * pl.bands
    assert pl.blocks <= 2 * 132 or pl.bands == 1
    assert pl.rounds // pl.bands >= 4 or pl.bands == 1
    assert not any(pl.rounds % d == 0 and pl.tiles * d <= 2 * 132
                   and pl.rounds // d >= 4
                   for d in range(pl.bands + 1, pl.rounds + 1))
    seen = np.zeros((pl.tiles, pl.rounds), np.int64)
    for b in range(pl.blocks):
        ct, lo, hi = k4.decode_band(pl, b)
        assert hi - lo == pl.rounds // pl.bands
        seen[ct, lo:hi] += 1
    assert (seen == 1).all()


def test_run_workload_and_generation_agreement_match_jax():
    """The engine-vs-engine drivers of serve/quality.py: the same streams
    from the same int8 workload, and the same agreement figures."""
    from repro.serve import generation_agreement as j_agreement
    from repro.serve import run_workload as j_run
    from repro_torch.serve import generation_agreement, run_workload
    jcfg, params, tcfg, tparams = _models("serve-core")
    kw = dict(max_slots=2, max_len=48, quant="int8")
    want = j_run(JServeEngine(params, jcfg, JServeConfig(
        decode_kernel=False, **kw)), RAGGED[:3], 4)
    got = run_workload(ServeEngine(tparams, tcfg, ServeConfig(
        device="cpu", **kw)), RAGGED[:3], 4)
    assert got == want
    other = {u: s[:-1] + [s[-1] + 1] for u, s in got.items()}
    other[1] = other[1][:2]
    assert generation_agreement(got, other) == j_agreement(want, other)
    assert generation_agreement(got, want)["identical"] == 1.0
