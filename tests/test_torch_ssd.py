"""The port's SSD blocks (``repro_torch.models.ssd``) against the JAX
package's ``repro.models.ssd`` on the CPU, and the reference's own checks
of ``tests/test_ssd.py`` run on the port.

Bounds: the chunked scan against the naive recurrence within 2e-4, block
decode against the full-sequence block within 1e-4 (tests/test_ssd.py's
bounds); the port against JAX within 1e-5 on the same inputs, made from a
seed with numpy. The reference's ``init_ssd`` sets ``conv_b`` and
``conv_c`` to zeros, which makes B and C silu(0) = 0 and leaves the state
path dead (only the D skip and ``conv_x`` carry signal), so every
block-level parity test here draws them from N(0, 0.2) and asserts that
the state it compares is nonzero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssd as jssd
from repro_torch.models import ssd as tssd


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny ops: one torch thread while this file runs (idle intra-op
    threads cost a loaded host several times the file's run time)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dtype is None else t.to(dtype)


def _inputs(seed, b, s, h, p, n):
    """x, dt = softplus(N(0, 1)), a = -exp(N(0, 1)), B and C, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, h, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, h, n)).astype(np.float32)
    return x, dt, a, bm, cm


CASES = [(32, 8), (64, 16), (40, 16), (8, 8)]


@pytest.mark.parametrize("s,chunk", CASES)
def test_chunked_equals_naive(s, chunk):
    """tests/test_ssd.py::test_chunked_equals_naive on the port (40 % 16:
    the tail padded with dt = 0)."""
    x, dt, a, bm, cm = (_t(v) for v in _inputs(0, 2, s, 4, 8, 16))
    y_ref, st_ref = tssd.ssd_naive(x, dt, a, bm, cm)
    y, st = tssd.ssd_chunked(x, dt, a, bm, cm, chunk)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=2e-4)
    np.testing.assert_allclose(st.numpy(), st_ref.numpy(), atol=2e-4)


@pytest.mark.parametrize("s,chunk", CASES)
def test_scans_match_jax(s, chunk):
    """``ssd_chunked`` and ``ssd_naive`` within 1e-5 of JAX's on the same
    inputs, from a nonzero initial state, relative to the largest value
    (these unit-normal inputs give outputs up to ~25; the blocks' below
    are O(1) and held to 1e-5 absolute)."""
    arrs = _inputs(1, 2, s, 4, 8, 16)
    init = np.random.default_rng(2).standard_normal((2, 4, 16, 8)).astype(
        np.float32)
    jargs = [jnp.asarray(v) for v in arrs]
    targs = [_t(v) for v in arrs]
    for jfn, tfn, extra in ((jssd.ssd_chunked, tssd.ssd_chunked, (chunk,)),
                            (jssd.ssd_naive, tssd.ssd_naive, ())):
        jy, js = jfn(*jargs, *extra, init_state=jnp.asarray(init))
        ty, ts = tfn(*targs, *extra, init_state=_t(init))
        for got, want in ((ty, jy), (ts, js)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, atol=1e-5 * float(np.abs(want).max()))


def test_initial_state_threading():
    x, dt, a, bm, cm = (_t(v) for v in _inputs(3, 1, 32, 2, 4, 8))
    y_full, st_full = tssd.ssd_chunked(x, dt, a, bm, cm, 8)
    y1, st1 = tssd.ssd_chunked(x[:, :16], dt[:, :16], a, bm[:, :16],
                               cm[:, :16], 8)
    y2, st2 = tssd.ssd_chunked(x[:, 16:], dt[:, 16:], a, bm[:, 16:],
                               cm[:, 16:], 8, init_state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=2e-4)
    np.testing.assert_allclose(st2.numpy(), st_full.numpy(), atol=2e-4)


@pytest.mark.parametrize("b,h", [(1, 2), (2, 3), (3, 6)])
def test_state_decay_bounded(b, h):
    """With x = 0 the state decays (A < 0): tests/test_ssd.py's property
    at three of its (b, h) draws."""
    s, p, n = 16, 4, 8
    _, st = tssd.ssd_chunked(torch.zeros(b, s, h, p),
                             torch.full((b, s, h), 0.5), -torch.ones(h),
                             torch.zeros(b, s, h, n), torch.zeros(b, s, h, n),
                             8, init_state=torch.ones(b, h, n, p))
    assert float(st.abs().max()) < 1.0


CFG = dict(d_model=32, d_state=16, head_dim=8, expand=2, chunk=8)


def _live_params(cfg_kw, seed=0, dtype=jnp.float32):
    """JAX ``init_ssd`` params in ``dtype`` with ``conv_b``/``conv_c``
    drawn N(0, 0.2) from a numpy seed (the zeros of init leave the state
    dead), and the same arrays as the port's tree."""
    jcfg = jssd.SSDConfig(**cfg_kw)
    jp = jssd.init_ssd(jax.random.PRNGKey(seed), jcfg, dtype=dtype).params
    rng = np.random.default_rng(seed + 100)
    for k in ("conv_b", "conv_c"):
        jp[k] = jnp.asarray(rng.normal(0.0, 0.2, jp[k].shape),
                            jnp.float32).astype(dtype)
    tp = jax.tree.map(lambda v: _t(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32), jp)
    return jcfg, tssd.SSDConfig(**cfg_kw), jp, tp


def test_block_decode_equals_full():
    """tests/test_ssd.py::test_block_decode_equals_full on the port, with
    live B and C: decode, step by step from a zero state, within 1e-4 of
    the full-sequence block."""
    _, cfg, _, tp = _live_params(CFG, seed=2)
    x = _t(np.random.default_rng(3).standard_normal((2, 12, 32)) * 0.5)
    y_full = tssd.ssd_block(tp, cfg, x)
    state = tssd.init_ssd_state(cfg, 2, dtype=torch.float32)
    ys = [tssd.ssd_block_decode(tp, cfg, x[:, t:t + 1], state)[0]
          for t in range(12)]
    np.testing.assert_allclose(y_full.numpy(), torch.cat(ys, 1).numpy(),
                               atol=1e-4)
    assert float(state.ssm.abs().max()) > 1e-3


def test_block_grads_finite():
    _, cfg, _, tp = _live_params(dict(CFG, d_state=8), seed=4)
    leaves = {k: v.requires_grad_() for k, v in tp.items()
              if isinstance(v, torch.Tensor)}
    x = _t(np.random.default_rng(5).standard_normal((2, 16, 32)))
    (tssd.ssd_block(tp, cfg, x) ** 2).sum().backward()
    assert all(bool(torch.isfinite(v.grad).all()) for v in leaves.values())
    assert float(leaves["conv_b"].grad.abs().max()) > 0


@pytest.mark.parametrize("s", [12, 19])
def test_block_and_decode_match_jax(s):
    """``ssd_block`` over a sequence (19: a padded tail chunk) and then
    ``ssd_block_decode`` from its state, against JAX within 1e-5, the
    state leaves too (the port's updated in place)."""
    jcfg, cfg, jp, tp = _live_params(CFG, seed=6)
    x = np.random.default_rng(7).standard_normal((2, s + 3, 32)).astype(
        np.float32) * 0.5
    want = jssd.ssd_block(jp, jcfg, jnp.asarray(x[:, :s]))
    got = tssd.ssd_block(tp, cfg, _t(x[:, :s]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    rng = np.random.default_rng(8)
    st0 = {k: rng.standard_normal(getattr(
        jssd.init_ssd_state(jcfg, 2, jnp.float32), k).shape).astype(
        np.float32) for k in tssd.SSD_LEAVES}
    jst = jssd.SSDState(**{k: jnp.asarray(v) for k, v in st0.items()})
    tst = tssd.SSDState(**{k: _t(v) for k, v in st0.items()})
    for t in range(s, s + 3):
        jy, jst = jssd.ssd_block_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                        jst)
        ty, same = tssd.ssd_block_decode(tp, cfg, _t(x[:, t:t + 1]), tst)
        assert same is tst
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
        for k in tssd.SSD_LEAVES:
            np.testing.assert_allclose(getattr(tst, k).numpy(),
                                       np.asarray(getattr(jst, k)),
                                       atol=1e-5, err_msg=k)
    assert float(tst.ssm.abs().max()) > 1e-3


def test_bf16_block_matches_jax():
    """bf16 params, inputs and conv state (the bf16 serve mode): the conv
    multiplies in bf16 (``_causal_dwconv``), the decode window sums in
    fp32 and casts back (``_dwconv_step``), silu rounds op by op as XLA's
    does (``ssd.silu``); the block, three decode steps and the conv
    windows equal JAX's bit for bit."""
    jcfg, cfg, jp, tp = _live_params(CFG, seed=9, dtype=jnp.bfloat16)
    x = np.random.default_rng(10).standard_normal((2, 11, 32)).astype(
        np.float32) * 0.5
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jssd.ssd_block(jp, jcfg, xb[:, :8])
    got = tssd.ssd_block(tp, cfg, _t(x[:, :8], torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    jst = jssd.init_ssd_state(jcfg, 2, jnp.bfloat16)
    tst = tssd.init_ssd_state(cfg, 2, torch.bfloat16)
    for t in range(8, 11):
        jy, jst = jssd.ssd_block_decode(jp, jcfg, xb[:, t:t + 1], jst)
        ty, _ = tssd.ssd_block_decode(tp, cfg,
                                      _t(x[:, t:t + 1], torch.bfloat16), tst)
        np.testing.assert_array_equal(ty.float().numpy(),
                                      np.asarray(jy, np.float32))
    for k in ("conv_x", "conv_b", "conv_c"):
        assert getattr(jst, k).dtype == jnp.bfloat16
        np.testing.assert_array_equal(getattr(tst, k).float().numpy(),
                                      np.asarray(getattr(jst, k), np.float32))


def test_mixed_dtype_conv_state_is_the_cache_dtype():
    """fp32 inputs over a bf16 conv state: JAX's ``jnp.concatenate``
    promotes the window, so its new state is fp32 and holds the new input
    exactly; the port writes into the bf16 cache, so its state is JAX's
    rounded to bf16. The outputs of the step itself agree (the window is
    summed in fp32 either way). A difference by design (ROADMAP queue 3)."""
    rng = np.random.default_rng(11)
    x_new = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    state = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    kernel = rng.standard_normal((4, 4, 8)).astype(np.float32)
    jstate = jnp.asarray(state).astype(jnp.bfloat16)
    jy, jnew = jssd._dwconv_step(jnp.asarray(x_new), jstate,
                                 jnp.asarray(kernel))
    tstate = _t(state, torch.bfloat16)
    ty = tssd._dwconv_step(_t(x_new), tstate, _t(kernel))
    assert jnew.dtype == jnp.float32 and tstate.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_array_equal(
        tstate.float().numpy(),
        np.asarray(jnew.astype(jnp.bfloat16), np.float32))
    assert not np.array_equal(tstate.float().numpy(), np.asarray(jnew))


def test_silu_is_jax_silu():
    """bf16: equal to ``jax.nn.silu`` bit for bit (``F.silu`` is not);
    fp32: within an ulp of the largest value."""
    x = np.random.default_rng(13).standard_normal(4096).astype(
        np.float32) * 4
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        tssd.silu(_t(x, torch.bfloat16)).float().numpy(),
        np.asarray(jax.nn.silu(xb), np.float32))
    np.testing.assert_allclose(tssd.silu(_t(x)).numpy(),
                               np.asarray(jax.nn.silu(jnp.asarray(x))),
                               atol=2e-6)


def test_softplus_is_jax_softplus():
    """No threshold: ``F.softplus`` returns x itself past 20, JAX's
    softplus does not round there."""
    x = np.array([-30.0, -5.0, 0.0, 3.0, 19.9, 20.5, 40.0], np.float32)
    np.testing.assert_allclose(tssd.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


def test_causal_dwconv_matches_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 7, 3, 5)).astype(np.float32)
    k = rng.standard_normal((4, 3, 5)).astype(np.float32)
    for s in (7, 2):          # a sequence shorter than the window too
        np.testing.assert_allclose(
            tssd._causal_dwconv(_t(x[:, :s]), _t(k)).numpy(),
            np.asarray(jssd._causal_dwconv(jnp.asarray(x[:, :s]),
                                           jnp.asarray(k))), atol=1e-6)


def test_init_ssd_mirrors_the_reference():
    """The port's ``init_ssd`` gives JAX's leaves, shapes and dtypes (bf16
    weights, the fp32 dt_bias, a_log and d_skip, the inner norm's scale in
    the weights' dtype), JAX's ``a_log`` and ``d_skip`` exactly, zeros in
    ``conv_b``/``conv_c``, and a ``dt_bias`` whose softplus lies in
    [dt_min, dt_max]. (``a_log`` to an fp32 ulp: the two linspaces round
    differently.)"""
    cfg_kw = dict(d_model=64, d_state=16, head_dim=16)
    jp = jssd.init_ssd(jax.random.PRNGKey(0), jssd.SSDConfig(**cfg_kw),
                       dtype=jnp.bfloat16).params
    gen = torch.Generator().manual_seed(0)
    cfg = tssd.SSDConfig(**cfg_kw)
    tp = tssd.init_ssd(cfg, (3,), generator=gen, device="cpu",
                       dtype=torch.bfloat16)
    flat_j = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", (tuple(v.shape[1:]),
                                           str(v.dtype).split(".")[-1])

    assert dict(walk(tp)) == flat_j
    for r in range(3):
        np.testing.assert_allclose(tp["a_log"][r].numpy(),
                                   np.asarray(jp["a_log"]), rtol=1e-6)
    assert bool((tp["d_skip"] == 1).all())
    assert not tp["conv_b"].any() and not tp["conv_c"].any()
    dt = tssd.softplus(tp["dt_bias"])
    assert float(dt.min()) >= cfg.dt_min * 0.999
    assert float(dt.max()) <= cfg.dt_max * 1.001
    assert float(tp["conv_x"].float().abs().max()) <= 0.4
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jssd.SSDConfig(**cfg_kw))
    assert (cfg.d_inner, cfg.n_heads) == (128, 8)
