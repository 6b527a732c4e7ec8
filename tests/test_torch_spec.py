"""The port's speculative decode (drafter, accept step, K5's plain version,
``paged_verify_step`` and the speculative engine) against the JAX package
on the same numpy inputs and bridged fp32 weights, on the CPU.

On the CPU the port's kernels run their plain versions (``kernels/ref.py``);
the CUDA kernel K5 is held against its plain version on the card by
chip_smoke.py. Bounds: drafts, greedy accept decisions and greedy streams
exactly equal; K5's plain version within 1e-5 of the Pallas kernel
(interpret mode) on rows with at least one valid key, exact zeros on the
rest (the Pallas kernel averages V there; the engine never reads such
rows); logits within 1e-4 and fp caches within 1e-5 outside the sink page
(dead lanes dump path-dependent values there by design); int8 caches
within one scale step, a code differing from JAX's by one only at a
rounding tie; per-tick bills equal to 1e-9 relative. At temperature > 0
the port does not reproduce JAX's threefry bits: its draws are held to
the target distribution (total variation below 0.05 over 4,000 uids),
to determinism and to independence from the slot. The JAX engines run at
``decode_kernel=False`` (their CPU path), except one small run through
the Pallas verify kernel in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import starcoder2_7b as j_sc2
from repro.kernels import ops as jops
from repro.models import transformer as jtf
from repro.quant import int8 as jq
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import spec as jspec
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels import paged_verify_attention as k5
from repro_torch.models import transformer as ttf
from repro_torch.serve import ServeConfig, ServeEngine, StepMetrics
from repro_torch.serve import spec as tspec


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


def _core_cfg():
    """tests/test_serve_spec.py::_cfg."""
    return jtf.LMConfig(name="t", d_model=48, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=61, pattern=(jtf.BlockSpec(),),
                        repeats=2, remat="none", vocab_pad_multiple=1)


CFGS = {"starcoder2-smoke": j_sc2.make_smoke, "serve-core": _core_cfg}
_CACHE = {}


def _models(name, quant=False):
    """(JAX cfg, JAX params, port cfg, port params), fp32 or quantized by
    JAX's quantize_lm and bridged."""
    key = (name, quant)
    if key not in _CACHE:
        jcfg = CFGS[name]()
        params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                             dtype=jnp.float32).params
        if quant:
            params = jtf.quantize_lm(params)
            jcfg = dataclasses.replace(jcfg, quant=jtf.INT8_QUANT)
        tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
        tparams = bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        _CACHE[key] = (jcfg, params, tcfg, tparams)
    return _CACHE[key]


def _t(a):
    return torch.from_numpy(np.array(a))


# -----------------------------------------------------------------------------
# The drafter and the accept step
# -----------------------------------------------------------------------------

def test_ngram_draft_equals_jax():
    """Random short-alphabet histories (many matches, matches near the
    end) and a no-match row, at every pos from 0 to the end."""
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 4, (6, 24)).astype(np.int32)
    hist[5] = np.arange(24)                     # no bigram repeats
    for k in (1, 3, 5):
        for p in range(24):
            pos = np.full(6, p, np.int32)
            pos[1] = min(p, 1)                  # pos 0 and 1 in every batch
            want = np.asarray(jspec.ngram_draft(jnp.asarray(hist),
                                                jnp.asarray(pos), k))
            got = tspec.ngram_draft(_t(hist).long(), _t(pos).long(), k)
            np.testing.assert_array_equal(got.numpy(), want)
    # a no-match row repeats its pending token
    got = tspec.ngram_draft(_t(hist).long(), torch.full((6,), 9), 3)
    assert got[5].tolist() == [9, 9, 9]


def _onehot_logits(picks, vocab=8):
    lg = np.zeros((1, len(picks), vocab), np.float32)
    for j, p in enumerate(picks):
        lg[0, j, p] = 5.0
    return lg


GREEDY_CASES = {
    "accept-all": ([3, 1, 4, 7], [3, 1, 4], 3, 7),
    "reject-all": ([3, 1, 4], [0, 0], 0, 3),
    "mid-run": ([3, 1, 4, 6], [3, 2, 4], 1, 1),
}


@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_greedy_accept_equals_jax(case):
    """The cases of tests/test_serve_spec.py, then random logits with
    drafts that hit the argmax for a random prefix."""
    picks, drafts, n_acc, fix = GREEDY_CASES[case]
    lg, d = _onehot_logits(picks), np.asarray([drafts], np.int64)
    cases = [(lg, d)]
    rng = np.random.default_rng(1)
    lg2 = rng.standard_normal((16, len(picks), 8)).astype(np.float32)
    d2 = lg2[:, :-1].argmax(-1)
    cut = rng.integers(0, len(drafts) + 1, 16)
    for i, c in enumerate(cut):
        d2[i, c:] = (d2[i, c:] + 1) % 8
    cases.append((lg2, d2))
    for logits, dr in cases:
        b = logits.shape[0]
        jn, jf, _ = jspec.speculative_accept(
            jnp.asarray(logits), jnp.asarray(dr, jnp.int32),
            jax.random.split(jax.random.PRNGKey(0), b), jnp.zeros(b))
        tn, tf = tspec.speculative_accept(
            _t(logits), _t(dr).long(), torch.zeros(b), seed=0,
            uid=torch.arange(b), gen=torch.zeros(b, dtype=torch.long),
            sampled=False)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    first = tspec.speculative_accept(
        _t(lg), _t(d).long(), torch.zeros(1), seed=0, uid=torch.zeros(1),
        gen=torch.zeros(1, dtype=torch.long), sampled=False)
    assert (int(first[0][0]), int(first[1][0])) == (n_acc, fix)


def _sampled_accept(logits, drafts, temp, uid, gen, seed=0):
    b = logits.shape[0]
    return tspec.speculative_accept(
        _t(logits), _t(drafts).long(), torch.full((b,), temp), seed=seed,
        uid=_t(uid).long(), gen=_t(gen).long(), sampled=True)


def test_temperature_never_emits_the_rejected_draft():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((256, 2, 8)).astype(np.float32)
    n_acc, fix = _sampled_accept(lg, np.full((256, 1), 2), 1.5,
                                 np.arange(256), np.zeros(256))
    rejected = n_acc.numpy() == 0
    assert rejected.any() and (~rejected).any()
    assert not (fix.numpy()[rejected] == 2).any()


def test_temperature_draws_deterministic_and_slot_independent():
    """The same (seed, uid, token index) gives the same draws in any row
    of any batch; another seed gives other draws."""
    rng = np.random.default_rng(2)
    lg = rng.standard_normal((64, 4, 8)).astype(np.float32)
    drafts = rng.integers(0, 8, (64, 3))
    uid, gen = np.arange(64) + 100, rng.integers(0, 30, 64)
    a = _sampled_accept(lg, drafts, 0.9, uid, gen)
    b = _sampled_accept(lg, drafts, 0.9, uid, gen)
    perm = rng.permutation(64)
    c = _sampled_accept(lg[perm], drafts[perm], 0.9, uid[perm], gen[perm])
    d = _sampled_accept(lg, drafts, 0.9, uid, gen, seed=1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(a, c):
        assert torch.equal(x[perm], y)
    assert not all(torch.equal(x, y) for x, y in zip(a, d))


def test_first_emitted_token_follows_the_target_softmax():
    """One logit row at temperature 0.8 for 4,000 uids, the draft a
    likely token: the first emitted token (the draft if accepted, else the
    residual draw) must be distributed as softmax(l / 0.8). Total
    variation below 0.05 (its sampling spread at 4,000 draws over 8
    tokens is about 0.02)."""
    n = 4000
    row = np.array([1.0, 0.2, 2.0, -1.0, 0.5, 0.0, 1.5, -0.5], np.float32)
    lg = np.broadcast_to(row, (n, 2, 8)).copy()
    n_acc, fix = _sampled_accept(lg, np.full((n, 1), 2), 0.8, np.arange(n),
                                 np.full(n, 5))
    first = np.where(n_acc.numpy() > 0, 2, fix.numpy())
    emp = np.bincount(first, minlength=8) / n
    p = np.exp(row / 0.8) / np.exp(row / 0.8).sum()
    assert 0.5 * np.abs(emp - p).sum() < 0.05


# -----------------------------------------------------------------------------
# K5: the plain version against the Pallas kernel (interpret mode)
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [-1, 6])
@pytest.mark.parametrize("t", [1, 3])
def test_paged_verify_plain_matches_pallas(t, window, int8):
    """Ragged lengths counting the T lanes: a dead slot, lengths 1 and 2
    (below T = 3, so some rows have no valid key), and 34 past the table's
    capacity of 32 (q_pos comes from the unclamped length)."""
    rng = np.random.default_rng(3)
    b, ps, nb, hkv, rep, d, npages = 6, 8, 4, 2, 3, 16, 24
    q = rng.standard_normal((b, t, hkv * rep, d)).astype(np.float32)
    kpool = rng.standard_normal((npages + 1, ps, hkv, d)).astype(np.float32)
    vpool = rng.standard_normal((npages + 1, ps, hkv, d)).astype(np.float32)
    pt = rng.permutation(npages)[:b * nb].reshape(b, nb).astype(np.int32)
    lens = np.array([24, 10, 0, 2, 1, 34], np.int32)
    scales = {}
    if int8:
        kpool, ks = jq.quantize_rowwise(jnp.asarray(kpool))
        vpool, vs = jq.quantize_rowwise(jnp.asarray(vpool))
        scales = dict(k_scale=ks, v_scale=vs)
    args = (q, kpool, vpool, pt, lens)
    want = np.asarray(jops.paged_verify_attention(
        *map(jnp.asarray, args), scale=0.25, window=window, interpret=True,
        **scales))
    got = ops.paged_verify_attention(
        *map(_t, args), scale=0.25, window=window,
        **{k: _t(v) for k, v in scales.items()}).numpy()
    # a row has a valid key iff its lane's q_pos >= 0 in a live slot (the
    # lanes past the capacity still see the keys below it in this window)
    q_pos = lens[:, None] - t + np.arange(t)[None]
    has_key = (lens[:, None] > 0) & (q_pos >= 0)
    excluded = int((~has_key).sum())
    assert excluded == {1: 1, 3: 6}[t]
    assert np.abs(got[has_key] - want[has_key]).max() < 1e-5
    assert (got[~has_key] == 0.0).all() and (want[2] == 0.0).all()
    if t == 1:
        k2 = ops.paged_decode_attention(
            _t(q[:, 0]), *map(_t, args[1:]), scale=0.25, window=window,
            **{k: _t(v) for k, v in scales.items()})
        assert torch.equal(torch.from_numpy(got[:, 0]), k2)


def test_paged_verify_cpu_path_does_not_touch_the_kernel():
    x = torch.zeros((1, 2, 2, 16))
    pool = torch.zeros((3, 4, 1, 16))
    pt = torch.zeros((1, 2), dtype=torch.int32)
    before = k5.paged_verify_attention.launches
    ops.paged_verify_attention(x, pool, pool, pt,
                               torch.full((1,), 3, dtype=torch.int32))
    assert k5.paged_verify_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        k5.paged_verify_attention(x, pool, pool, pt, pt[:, 0], scale=0.25)
    with pytest.raises(ValueError, match="both KV scales"):
        ops.paged_verify_attention(x, pool, pool, pt, pt[:, 0],
                                   k_scale=pool[..., 0])


# -----------------------------------------------------------------------------
# paged_verify_step against JAX's
# -----------------------------------------------------------------------------

NPAGES, PS, NSLOTS, NBLK = 16, 4, 2, 8


def _check_fp_pools(jc, tc, sink=NPAGES):
    for key, entry in jc.items():
        ax = 1 if key.startswith("pat") else 0
        for name in ("k", "v"):
            want = np.delete(np.asarray(getattr(entry["kv"], name)), sink,
                             axis=ax)
            got = np.delete(getattr(tc[key]["kv"], name).numpy(), sink,
                            axis=ax)
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=key)


def _check_int8_pools(jc, tc, sink=NPAGES):
    """Dequantized within one scale step; a code off by one only at a
    rounding tie."""
    for key, entry in jc.items():
        ax = 1 if key.startswith("pat") else 0
        for name in ("k", "v"):
            jcodes, jsc, tcodes, tsc = (
                np.delete(a, sink, axis=ax) for a in (
                    np.asarray(getattr(entry["kv"], name)).astype(np.int32),
                    np.asarray(getattr(entry["kv_scale"], name)),
                    getattr(tc[key]["kv"], name).numpy().astype(np.int32),
                    getattr(tc[key]["kv_scale"], name).numpy()))
            np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-12)
            step = np.maximum(jsc, tsc)[..., None]
            assert (np.abs(tcodes * tsc[..., None] - jcodes * jsc[..., None])
                    <= step * (1 + 1e-5)).all(), key
            assert np.abs(tcodes - jcodes).max() <= 1, key


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_paged_verify_step_matches_jax(name, quant):
    """One extend chunk, then two verify steps of T = 3 with one slot
    inactive (its lanes write to the sink), the second at the capacity
    edge for the live slot (its last lanes write to the sink too)."""
    jcfg, params, tcfg, tparams = _models(name, quant)
    jcfg = dataclasses.replace(jcfg, decode_kernel=False)
    jc = jtf.init_paged_caches(jcfg, NPAGES, PS, dtype=jnp.float32)
    tc = ttf.init_paged_caches(tcfg, NPAGES, PS, dtype=torch.float32,
                               device="cpu")
    rng = np.random.default_rng(3)
    pt = rng.permutation(NPAGES)[:NSLOTS * NBLK].reshape(
        NSLOTS, NBLK).astype(np.int32)
    lens = np.array([7, 5], np.int32)
    toks = rng.integers(0, jcfg.vocab, (NSLOTS, 8)).astype(np.int32)
    starts = np.zeros(NSLOTS, np.int32)
    _, jc = jtf.paged_extend(params, jcfg, jnp.asarray(toks),
                             jnp.asarray(starts), jnp.asarray(lens),
                             jnp.asarray(pt), jc)
    _, tc = ttf.paged_extend(tparams, tcfg, _t(toks).long(),
                             _t(starts).long(), _t(lens).long(), _t(pt), tc)
    active = np.array([True, False])
    check = _check_int8_pools if quant else _check_fp_pools
    for pos in (lens, np.array([NBLK * PS - 2, 5], np.int32)):
        chunk = rng.integers(0, jcfg.vocab, (NSLOTS, 3)).astype(np.int32)
        lj, jc = jtf.paged_verify_step(params, jcfg, jnp.asarray(chunk),
                                       jnp.asarray(pos), jnp.asarray(pt), jc,
                                       active=jnp.asarray(active))
        lt, tc = ttf.paged_verify_step(tparams, tcfg, _t(chunk).long(),
                                       _t(pos).long(), _t(pt), tc,
                                       active=_t(active))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        check(jc, tc)


# -----------------------------------------------------------------------------
# The speculative engine against JAX's and against the port's plain engine
# -----------------------------------------------------------------------------

RAGGED = [np.arange(30), np.arange(3) + 7, np.arange(21) + 2,
          np.arange(9) + 40]
SHARED = [np.concatenate([np.arange(12) + 20, np.arange(4) + 3 * i])
          for i in range(4)]
BILLED = [f.name for f in dataclasses.fields(StepMetrics)
          if f.name != "wall_s"]
SPEC_KEYS = ("spec_draft_tokens", "spec_accepted_tokens", "accept_rate",
             "accepted_tokens_per_tick", "spec_backoffs", "spec_k_current",
             "decode_tokens", "prefix_hit_tokens")


def _drain(eng, prompts, max_tokens):
    for p in prompts:
        eng.submit(np.asarray(p, np.int32), max_tokens=max_tokens)
    return {r.uid: list(r.generated) for r in eng.run_until_drained()}


def _engines(name, spec, quant=False, decode_kernel=False, **kw):
    """The JAX and the port speculative engine, and the port's plain paged
    engine, on the same weights and config."""
    jcfg, params, tcfg, tparams = _models(name)
    kw = {"max_slots": 2, "max_len": 64, "paged": True, "page_size": 4,
          "quant": "int8" if quant else "none", **kw}
    je = JServeEngine(params, jcfg, JServeConfig(decode_kernel=decode_kernel,
                                                 **kw, **spec))
    te = ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw, **spec))
    plain = ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw))
    return je, te, plain


def _assert_same_run(je, te):
    """Every StepMetrics field of every tick (wall time aside) and the
    summary's spec keys."""
    assert len(je.metrics_log) == len(te.metrics_log)
    for tick, (jm, tm) in enumerate(zip(je.metrics_log, te.metrics_log)):
        for f in BILLED:
            assert getattr(tm, f) == pytest.approx(getattr(jm, f), rel=1e-9,
                                                   abs=0.0), (tick, f)
    js, ts = je.summary(), te.summary()
    for key in SPEC_KEYS:
        assert ts[key] == pytest.approx(js[key], rel=1e-9), key


ENGINE_CASES = {
    "ngram-k1": ("serve-core", RAGGED, 8, dict(spec_k=1), {}),
    "ngram-k2": ("serve-core", RAGGED, 8, dict(spec_k=2), {}),
    "ngram-k4": ("serve-core", RAGGED, 8, dict(spec_k=4), {}),
    "oracle-k2": ("serve-core", RAGGED, 7,
                  dict(spec_k=2, spec_drafter="oracle"), {}),
    "int8-k2": ("serve-core", RAGGED, 6, dict(spec_k=2), {"quant": True}),
    # chunked prefill with the prefix cache on, on shared-prefix traffic
    "chunked-prefix": ("serve-core", SHARED, 6, dict(spec_k=2),
                       {"prefill_chunk": 8}),
    # a finish inside an accepted run: budget 2 below k + 1
    "finish-in-run": ("serve-core", RAGGED, 2,
                      dict(spec_k=4, spec_drafter="oracle"), {}),
    # the context cap inside an accepted run: draft lanes past max_len
    "max-len-cap": ("serve-core", [np.arange(10), np.arange(7) + 3], 12,
                    dict(spec_k=4), {"max_len": 16}),
    "smoke-ngram-k2": ("starcoder2-smoke", RAGGED, 6, dict(spec_k=2),
                       {"prefill_chunk": 8}),
    "smoke-oracle-k2": ("starcoder2-smoke", RAGGED, 5,
                        dict(spec_k=2, spec_drafter="oracle"), {}),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_spec_engine_matches_jax_and_plain(case):
    name, prompts, max_tokens, spec, kw = ENGINE_CASES[case]
    je, te, plain = _engines(name, spec, **kw)
    want = _drain(je, prompts, max_tokens)
    assert _drain(te, prompts, max_tokens) == want
    assert _drain(plain, prompts, max_tokens) == want
    _assert_same_run(je, te)
    assert te.pool.state_dict() == je.pool.state_dict()
    assert te.pool.audit() == [] and te.pool.live == 0
    if "oracle" in case:
        assert te.summary()["spec_accepted_tokens"] > 0
    if case == "chunked-prefix":
        assert te.summary()["prefix_hit_tokens"] > 0


def test_eos_inside_an_accepted_run():
    """An EOS inside an accepted run ends the emission there, as in the
    plain engine with the same eos_id. The oracle drafter's runs are
    accepted, and the EOS id is a token that streams emit only after their
    first two tokens."""
    _, _, plain = _engines("serve-core", {})
    ref = _drain(plain, RAGGED, 10)
    eos = min({t for g in ref.values() for t in g[2:]}
              - {g[0] for g in ref.values()})
    je, te, plain = _engines("serve-core",
                             dict(spec_k=4, spec_drafter="oracle"),
                             eos_id=eos)
    want = _drain(je, RAGGED, 10)
    assert _drain(te, RAGGED, 10) == want == _drain(plain, RAGGED, 10)
    assert any(g[-1] == eos and len(g) < 10 for g in want.values())
    _assert_same_run(je, te)


def test_spec_engine_matches_jax_through_the_verify_kernel():
    """The JAX engine through its Pallas K5 (interpret mode): the same
    streams and bills as the port's plain version, billed as on the card
    (the extend gather reads only the cached pages, as K3 does)."""
    je, te, _ = _engines("serve-core", dict(spec_k=2), decode_kernel=True,
                         max_len=16)
    te._kernel_path = True
    prompts = [np.arange(4), np.arange(3) + 7]
    assert _drain(te, prompts, 3) == _drain(je, prompts, 3)
    _assert_same_run(je, te)


def test_oracle_at_the_max_len_edge_matches_the_plain_engine():
    """The oracle drafter's passes reach positions past the table at the
    context cap; they write to the sink, so the streams stay the plain
    engine's."""
    _, te, plain = _engines("serve-core", dict(spec_k=4,
                                               spec_drafter="oracle"),
                            max_len=16)
    prompts = [np.arange(10), np.arange(7) + 3]
    assert _drain(te, prompts, 12) == _drain(plain, prompts, 12)


def test_spec_one_readback_per_tick_and_private_write_windows():
    """One host readback per tick, and every page a verify tick writes
    ([pos, pos + k] below max_len) is the slot's own private page: without
    forks the copy-on-write barrier copies nothing. Refcounts return to
    their baseline after the drain."""
    _, te, _ = _engines("serve-core", dict(spec_k=4), prefill_chunk=8)
    for p in SHARED[:2]:
        te.submit(p, max_tokens=40)
    te.step()                               # admission + first tick
    te.step()
    base = te.host_readbacks
    for i in range(3):                      # no admission, no finish
        st = te.state
        for slot in range(2):
            if not bool(st.active[slot]):
                continue
            pos = int(st.pos[slot])
            for p in range(pos, min(pos + 5, te.scfg.max_len)):
                page = int(st.page_table[slot, p // 4])
                assert page != te.pool.sink and te.pool.writable(page)
        assert te.step() == []
        assert te.host_readbacks == base + i + 1
    te.run_until_drained()
    assert te.pool.live == 0 and te.pool.audit() == []
    assert te.summary()["cow_copies"] == 0


def test_spec_config_validation():
    tcfg, tparams = _models("serve-core")[2:]
    bad = (dict(spec_k=-1, paged=True), dict(spec_k=2),
           dict(spec_k=2, paged=True, spec_drafter="psychic"),
           dict(spec_k=2, paged=True, spec_tree_m=0),
           dict(paged=True, spec_tree_m=2),
           dict(spec_k=2, paged=True, spec_tree_m=2, spec_drafter="oracle"))
    for kw in bad:
        with pytest.raises(ValueError):
            ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw))
    # tests/test_serve_cow.py::TestTreeSpec::test_tree_config_validation
    for kw, match in ((dict(spec_tree_m=0), "spec_tree_m"),
                      (dict(spec_tree_m=2), "spec_k"),
                      (dict(spec_k=2, spec_tree_m=2, spec_drafter="oracle"),
                       "ngram")):
        with pytest.raises(ValueError, match=match):
            ServeEngine(tparams, tcfg, ServeConfig(device="cpu", paged=True,
                                                   page_size=4, max_slots=4,
                                                   max_len=64, **kw))
    tree = ServeEngine(tparams, tcfg, ServeConfig(device="cpu", paged=True,
                                                  spec_k=2, spec_tree_m=2))
    assert tree.scfg.spec_tree_m == 2


def test_launcher_serves_speculatively_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    launch.main(["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
                 "--requests", "3", "--max-tokens", "5", "--slots", "2",
                 "--paged", "--page-size", "4", "--spec-k", "2"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "accept rate" in out
    assert '"accept_rate"' in out
    with pytest.raises(SystemExit):
        launch.main(["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
                     "--spec-k", "2"])
