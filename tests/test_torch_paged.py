"""The port's paged KV serving (pool, K2/K3 plain versions, paged model
functions, paged engine) against the JAX package on the same numpy inputs
and bridged fp32 weights, on the CPU.

On the CPU the port's kernels run their plain versions (``kernels/ref.py``);
the CUDA kernels are held against those on the card by chip_smoke.py.
Bounds, as the JAX tests hold their own paged kernels and paths: 1e-5 on
the kernels' live rows (exact zeros on dead ones), 1e-4 on logits, 1e-5 on
caches outside the sink page (dead and padded lanes dump path-dependent
values there by design), exact equality for page moves, identical greedy
streams, and per-tick bills equal to 1e-9 relative. The JAX model and
engine run at ``decode_kernel=False``, their CPU path.
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
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as k2
from repro_torch.kernels import paged_prefill_attention as k3
from repro_torch.models import transformer as ttf
from repro_torch.serve import ServeConfig, ServeEngine, StepMetrics


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
    """tests/test_serve_paged.py::_cfg."""
    return jtf.LMConfig(name="t", d_model=48, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=61, pattern=(jtf.BlockSpec(),),
                        repeats=2, remat="none", vocab_pad_multiple=1)


CFGS = {"starcoder2-smoke": j_sc2.make_smoke, "serve-core": _core_cfg}
_CACHE = {}


def _models(name):
    if name not in _CACHE:
        jcfg = CFGS[name]()
        params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                             dtype=jnp.float32).params
        tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
        tparams = bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        _CACHE[name] = (jcfg, params, tcfg, tparams)
    return _CACHE[name]


def _t(a):
    return torch.from_numpy(np.array(a))


# -----------------------------------------------------------------------------
# K2 and K3: the plain versions against the Pallas kernels (interpret mode)
# -----------------------------------------------------------------------------

def _pools(rng, npages, ps, hkv, d):
    k = rng.standard_normal((npages + 1, ps, hkv, d)).astype(np.float32)
    v = rng.standard_normal((npages + 1, ps, hkv, d)).astype(np.float32)
    return k, v


@pytest.mark.parametrize("window", [-1, 6])
@pytest.mark.parametrize("rep,d", [(1, 16), (3, 16), (9, 128)])
def test_paged_decode_plain_matches_pallas(rep, d, window):
    """Ragged lengths with 0 and 1, a fragmented table."""
    rng = np.random.default_rng(3)
    b, ps, nb, hkv, npages = 5, 8, 4, 2, 24
    q = rng.standard_normal((b, hkv * rep, d)).astype(np.float32)
    kpool, vpool = _pools(rng, npages, ps, hkv, d)
    pt = rng.permutation(npages)[:b * nb].reshape(b, nb).astype(np.int32)
    lens = np.array([24, 10, 0, 1, 32], np.int32)
    scale = d ** -0.5
    got = ops.paged_decode_attention(_t(q), _t(kpool), _t(vpool), _t(pt),
                                     _t(lens), scale=scale,
                                     window=window).numpy()
    want = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(pt), jnp.asarray(lens), scale=scale, window=window,
        interpret=True))
    live = lens > 0
    assert np.abs(got[live] - want[live]).max() < 1e-5
    assert (got[~live] == 0.0).all() and (want[~live] == 0.0).all()


@pytest.mark.parametrize("window", [-1, 6])
@pytest.mark.parametrize("frag", [False, True],
                         ids=["contiguous", "fragmented"])
def test_paged_prefill_plain_matches_pallas(frag, window):
    """An unaligned start, a short row and a dead row (the inputs of
    tests/test_serve_longctx.py::TestPagedPrefillKernelOps)."""
    b, c, h, hkv, d, ps, npages, nbk = 3, 5, 4, 2, 8, 4, 16, 4
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, c, h, d)).astype(np.float32)
    k_new = rng.normal(size=(b, c, hkv, d)).astype(np.float32)
    v_new = rng.normal(size=(b, c, hkv, d)).astype(np.float32)
    kpool, vpool = _pools(rng, npages - 1, ps, hkv, d)
    order = rng.permutation(npages)[:b * nbk] if frag else np.arange(b * nbk)
    pt = order.reshape(b, nbk).astype(np.int32)
    starts = np.array([13, 4, 0], np.int32)
    lens = np.array([5, 3, 0], np.int32)
    scale = 1.0 / np.sqrt(d)
    args = (q, k_new, v_new, kpool, vpool, pt, starts, lens)
    got = ops.paged_prefill_attention(*map(_t, args), scale=scale,
                                      window=window).numpy()
    want = np.asarray(jops.paged_prefill_attention(
        *map(jnp.asarray, args), scale=scale, window=window,
        interpret=True))
    # every lane of a live row, the padding lanes past its length too
    # (they attend the row's keys, as the Pallas kernel's do); the dead
    # row is zeros
    live = lens > 0
    assert np.abs(got[live] - want[live]).max() < 1e-5
    assert (got[~live] == 0.0).all() and (want[2] == 0.0).all()


def test_paged_cpu_path_does_not_touch_the_kernels():
    rng = np.random.default_rng(1)
    kpool, vpool = _pools(rng, 4, 4, 1, 16)
    q = torch.zeros((1, 2, 1, 16))
    pt = torch.zeros((1, 2), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    before = (k2.paged_decode_attention.launches,
              k3.paged_prefill_attention.launches)
    ops.paged_decode_attention(q[:, 0], _t(kpool), _t(vpool), pt, one)
    ops.paged_prefill_attention(q, q[:, :, :1], q[:, :, :1], _t(kpool),
                                _t(vpool), pt, one * 0, one)
    assert before == (k2.paged_decode_attention.launches,
                      k3.paged_prefill_attention.launches)


def test_paged_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is an error."""
    x = torch.zeros((1, 1, 2, 16))
    i = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        k2.paged_decode_attention(x[:, 0], x, x, i[None], i, scale=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        k3.paged_prefill_attention(x, x, x, x, x, i[None], i, i, scale=0.25)


def test_paged_ops_refuse_int8_kv():
    """The int8-KV mode takes both scales or neither: one scale without
    the other is refused before any kernel or plain version runs."""
    x = torch.zeros((1, 1, 2, 16))
    sc = torch.ones((1, 1, 2))
    i = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="both KV scales"):
        ops.paged_decode_attention(x[:, 0], x, x, i[None], i, k_scale=sc)
    with pytest.raises(ValueError, match="both KV scales"):
        ops.paged_prefill_attention(x, x, x, x, x, i[None], i, i, v_scale=sc)


# -----------------------------------------------------------------------------
# paged_extend, paged_decode_step and move_pages against the JAX functions
# -----------------------------------------------------------------------------

NPAGES, PS, NSLOTS, NBLK = 16, 4, 2, 8


def _check_pools(jc, tc, sink=NPAGES):
    """Pools within 1e-5 outside the sink page."""
    for key, entry in jc.items():
        ax = 1 if key.startswith("pat") else 0
        for name in ("k", "v"):
            want = np.delete(np.asarray(getattr(entry["kv"], name)), sink,
                             axis=ax)
            got = np.delete(getattr(tc[key]["kv"], name).numpy(), sink,
                            axis=ax)
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("frag", [False, True],
                         ids=["contiguous", "fragmented"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_paged_extend_and_decode_step_match_jax(name, frag):
    """Two ragged extend chunks (the second with a dead row), then three
    decode ticks with one lane inactive (its writes go to the sink)."""
    jcfg, params, tcfg, tparams = _models(name)
    jcfg = dataclasses.replace(jcfg, decode_kernel=False)
    jc = jtf.init_paged_caches(jcfg, NPAGES, PS, dtype=jnp.float32)
    tc = ttf.init_paged_caches(tcfg, NPAGES, PS, dtype=torch.float32,
                               device="cpu")
    rng = np.random.default_rng(3)
    order = (rng.permutation(NPAGES)[:NSLOTS * NBLK] if frag
             else np.arange(NSLOTS * NBLK))
    pt = order.reshape(NSLOTS, NBLK).astype(np.int32)
    starts = np.zeros(NSLOTS, np.int32)
    width = 8
    for chunk in ((7, 5), (6, 0)):
        lens = np.asarray(chunk, np.int32)
        toks = rng.integers(0, jcfg.vocab, (NSLOTS, width)).astype(np.int32)
        lj, jc = jtf.paged_extend(params, jcfg, jnp.asarray(toks),
                                  jnp.asarray(starts), jnp.asarray(lens),
                                  jnp.asarray(pt), jc)
        lt, tc = ttf.paged_extend(tparams, tcfg, _t(toks).long(),
                                  _t(starts).long(), _t(lens).long(),
                                  _t(pt), tc)
        live = lens > 0
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live],
                                   atol=1e-4)
        _check_pools(jc, tc)
        starts = starts + lens
    tok = rng.integers(0, jcfg.vocab, NSLOTS).astype(np.int32)
    pos = starts.copy()
    active = np.array([True, False])
    for _ in range(3):
        lj, jc = jtf.paged_decode_step(params, jcfg, jnp.asarray(tok[:, None]),
                                       jnp.asarray(pos), jnp.asarray(pt), jc,
                                       active=jnp.asarray(active))
        lt, tc = ttf.paged_decode_step(tparams, tcfg,
                                       _t(tok[:, None]).long(),
                                       _t(pos).long(), _t(pt), tc,
                                       active=_t(active))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        _check_pools(jc, tc)
        tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)
        pos = pos + active


def test_move_pages_equals_jax():
    """The same pools through both move_pages: exactly equal, including a
    destination that is also a source (the gather comes first) and
    sink->sink padding."""
    jcfg, _, tcfg, _ = _models("serve-core")
    rng = np.random.default_rng(7)
    jc = jtf.init_paged_caches(jcfg, NPAGES, PS, dtype=jnp.float32)
    jc = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jc)
    tc = ttf.init_paged_caches(tcfg, NPAGES, PS, dtype=torch.float32,
                               device="cpu")
    for key, entry in jc.items():
        tc[key]["kv"].k.copy_(_t(entry["kv"].k))
        tc[key]["kv"].v.copy_(_t(entry["kv"].v))
    src = np.array([3, 5, 9, NPAGES, NPAGES], np.int32)
    dst = np.array([5, 7, 1, NPAGES, NPAGES], np.int32)
    jc = jtf.move_pages(jc, jnp.asarray(src), jnp.asarray(dst))
    tc = ttf.move_pages(tc, _t(src), _t(dst))
    for key, entry in jc.items():
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                getattr(tc[key]["kv"], name).numpy(),
                np.asarray(getattr(entry["kv"], name)))


def test_init_paged_caches_layout_and_device():
    tcfg = _models("starcoder2-smoke")[2]
    tc = ttf.init_paged_caches(tcfg, 6, 4, dtype=torch.float32,
                               device="cpu")
    kv = tc["pat0"]["kv"]
    assert kv.k.shape == (tcfg.repeats, 7, 4, tcfg.n_kv_heads,
                          tcfg.resolved_head_dim)   # + the sink page
    assert ttf.paged_supported(tcfg)


# -----------------------------------------------------------------------------
# The paged engine against the JAX paged engine
# -----------------------------------------------------------------------------

RAGGED = [np.arange(30), np.arange(3) + 7, np.arange(21) + 2,
          np.arange(9) + 40]
# tests/test_serve_longctx.py::PROMPTS
LONGCTX = [np.arange(23) % 50, np.arange(11) % 50 + 3, np.arange(17) % 50]


def _shared_prefix_workload(n=6, prefix_len=12, tail_len=4):
    sys_prompt = np.arange(prefix_len) + 20
    return [np.concatenate([sys_prompt, np.arange(tail_len) + 3 * i])
            for i in range(n)]


def _pair(name, free_perm_seed=None, **kw):
    """The JAX and the port paged engine on the same weights and config."""
    jcfg, params, tcfg, tparams = _models(name)
    kw = dict(max_slots=2, max_len=64, paged=True, page_size=4, **kw)
    je = JServeEngine(params, jcfg, JServeConfig(decode_kernel=False, **kw))
    te = ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw))
    if free_perm_seed is not None:
        # both pools hand out the same scattered pages
        for eng in (je, te):
            rs = np.random.default_rng(free_perm_seed)
            eng.pool._free = [int(p) for p in rs.permutation(eng.pool._free)]
    return je, te


def _drain(eng, prompts, max_tokens):
    for p in prompts:
        eng.submit(np.asarray(p, np.int32), max_tokens=max_tokens)
    return {r.uid: list(r.generated) for r in eng.run_until_drained()}


BILLED = [f.name for f in dataclasses.fields(StepMetrics)
          if f.name != "wall_s"]


def _assert_bills_equal(je, te):
    """Every StepMetrics field of every tick, the wall time aside."""
    assert len(je.metrics_log) == len(te.metrics_log)
    for tick, (jm, tm) in enumerate(zip(je.metrics_log, te.metrics_log)):
        for f in BILLED:
            want, got = getattr(jm, f), getattr(tm, f)
            assert got == pytest.approx(want, rel=1e-9, abs=0.0), (tick, f)


WORKLOADS = {
    "ragged": (RAGGED, 6, {}),
    "ragged-chunked": (RAGGED, 6, {"prefill_chunk": 8}),
    "shared-prefix": (_shared_prefix_workload(), 5, {}),
    "tiny-pool": ([np.arange(12), np.arange(9) + 2, np.arange(7) + 11], 5,
                  {"num_pages": 5}),
    "evict-cost": (_shared_prefix_workload(n=4, prefix_len=8, tail_len=1), 5,
                   {"num_pages": 6, "evict_policy": "cost"}),
}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_paged_engine_matches_jax(workload):
    prompts, max_tokens, kw = WORKLOADS[workload]
    je, te = _pair("serve-core", **kw)
    want = _drain(je, prompts, max_tokens)
    assert _drain(te, prompts, max_tokens) == want
    assert all(len(s) == max_tokens for s in want.values())
    _assert_bills_equal(je, te)
    assert te.pool.state_dict() == je.pool.state_dict()
    assert te.pool.audit() == [] and te.pool.live == 0
    js, ts = je.summary(), te.summary()
    for key in ("prefix_hit_tokens", "prefix_hit_rate", "saved_bytes",
                "prefill_gather_bytes", "compaction_moves", "pool_pages",
                "pool_pages_live", "pool_hit_rate"):
        assert ts[key] == pytest.approx(js[key], rel=1e-9), key
    if workload == "shared-prefix":
        assert ts["prefix_hit_tokens"] > 0
    if workload == "evict-cost":
        assert te.pool.stats.evicted_blocks > 0


def test_paged_engine_matches_jax_starcoder2_smoke():
    je, te = _pair("starcoder2-smoke", prefill_chunk=8)
    assert _drain(te, RAGGED, 6) == _drain(je, RAGGED, 6)
    _assert_bills_equal(je, te)


def test_forced_compaction_matches_jax():
    """Scattered pages and a low threshold: both engines move the same
    pages on the same ticks, and the streams stay the dense engine's."""
    prompts = [np.arange(n) % 50 for n in (29, 17, 25, 9)]
    je, te = _pair("serve-core", free_perm_seed=5, prefill_chunk=8,
                   num_pages=24, compact_threshold=0.05)
    want = _drain(je, prompts, 6)
    assert _drain(te, prompts, 6) == want
    _assert_bills_equal(je, te)
    moves = sum(m.compaction_moves for m in te.metrics_log)
    assert moves > 0
    assert moves == sum(m.compaction_moves for m in je.metrics_log)
    tcfg, tparams = _models("serve-core")[2:]
    dense = ServeEngine(tparams, tcfg, ServeConfig(max_slots=2, max_len=64,
                                                   device="cpu"))
    assert _drain(dense, prompts, 6) == want
    assert te.pool.live == 0


def test_compacted_table_row_matches_host_mirror():
    tcfg, tparams = _models("serve-core")[2:]
    te = ServeEngine(tparams, tcfg, ServeConfig(
        max_slots=2, max_len=64, paged=True, page_size=4, prefill_chunk=8,
        num_pages=24, compact_threshold=0.05, prefix_cache=False,
        device="cpu"))
    # the pool pops from the END of _free: the slot gets scattered low
    # pages while a contiguous high run stays free for alloc_run
    te.pool._free = list(range(12, 24)) + [11, 9, 7, 5, 3, 1, 0, 2, 4, 6, 8,
                                           10]
    te.submit(np.arange(13) % 50, max_tokens=12)
    seen = False
    while te.slot_req[0] is not None or len(te.scheduler):
        te.step()
        if te.last_metrics.compaction_moves:
            seen = True
            pages = te._slot_pages[0]
            assert list(te.state.page_table[0, :len(pages)].tolist()) == pages
    assert seen


def test_kernel_path_gather_bill_matches_jax_formula():
    """On the card the extend path reads ceil(start / page_size) pages per
    row; the port bills that whenever it runs the kernels. Held against the
    JAX engine at decode_kernel=True (its Pallas K3 in interpret mode) on
    chunked prefill: the same streams and the same per-tick bills."""
    jcfg, params, tcfg, tparams = _models("serve-core")
    kw = dict(max_slots=2, max_len=64, paged=True, page_size=4,
              prefill_chunk=8, prefix_cache=False)
    je = JServeEngine(params, jcfg, JServeConfig(decode_kernel=True, **kw))
    te = ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw))
    te._kernel_path = True
    assert _drain(te, LONGCTX, 4) == _drain(je, LONGCTX, 4)
    _assert_bills_equal(je, te)
    gather = sum(m.prefill_gather_bytes for m in te.metrics_log)
    expect = sum(-(-s // 4) * 4 for p in LONGCTX
                 for s in range(8, len(p), 8))
    assert gather == pytest.approx(te._kv_token_bytes * expect)


def test_paged_one_host_readback_per_tick():
    _, te = _pair("serve-core")
    te.submit(np.arange(6), max_tokens=8)
    te.step()                               # admission + first tick
    base = te.host_readbacks
    for i in range(4):                      # no admission, no finish
        assert te.step() == []
        assert te.host_readbacks == base + i + 1
    te.run_until_drained()


def test_paged_submit_rejects_a_request_that_never_fits():
    _, te = _pair("serve-core", num_pages=4)    # 16-token capacity
    with pytest.raises(ValueError, match="pages"):
        te.submit(np.arange(20), max_tokens=8)
    te.submit(np.arange(8), max_tokens=4)
    assert len(te.run_until_drained()) == 1


def test_paged_queued_request_that_never_fits_fails_fast():
    """A request that reached the queue without submit()'s check and can
    never fit the pool is dropped and returned empty, not left to block
    the head of a FIFO queue; requests behind it still run."""
    from repro_torch.serve import Request
    _, te = _pair("serve-core", num_pages=8)
    te.scheduler.submit(Request(uid=999, prompt=np.arange(40) % 50,
                                max_tokens=20))
    te.submit(np.arange(6), max_tokens=3)
    done = {r.uid: r for r in te.run_until_drained()}
    assert done[999].done and done[999].generated == []
    assert len(done[1].generated) == 3


def test_paged_sampling_same_with_and_without_chunks():
    """Temperature 0.7: the draws are keyed on (seed, uid, token index),
    so chunking the admission changes nothing."""
    tcfg, tparams = _models("serve-core")[2:]

    def run(chunk):
        eng = ServeEngine(tparams, tcfg, ServeConfig(
            max_slots=2, max_len=64, paged=True, page_size=4,
            prefill_chunk=chunk, device="cpu"))
        for p in RAGGED:
            eng.submit(p, max_tokens=5, temperature=0.7)
        return {r.uid: r.generated for r in eng.run_until_drained()}

    a = run(0)
    assert a == run(8)
    greedy = _drain(_pair("serve-core")[1], RAGGED, 5)
    assert a != greedy


def test_paged_config_validation():
    tcfg, tparams = _models("serve-core")[2:]
    for bad in (dict(prefill_chunk=6), dict(compact_threshold=1.5),
                dict(evict_policy="mru")):
        with pytest.raises(ValueError):
            ServeEngine(tparams, tcfg, ServeConfig(
                paged=True, page_size=4, device="cpu", **bad))


def test_paged_engine_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg, tparams = _models("serve-core")[2:]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tparams, tcfg, ServeConfig(paged=True))


def test_launcher_serves_paged_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    launch.main(["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
                 "--requests", "3", "--max-tokens", "3", "--slots", "2",
                 "--prompt-len", "5", "30", "--paged", "--page-size", "4",
                 "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and '"pool_pages"' in out


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """Each library's key hashes its source and every csrc/ header it
    includes, so an edited shared header rebuilds exactly the libraries
    that include it: decode_attention.cuh K1, K2, K3 and K5, hopper.cuh
    every library (K11 through coded_gemm.cuh),
    paged_decode_split.cuh K1, K2 and K5, the split body they share,
    coded_gemm.cuh K4/K9 and K11, the coded GEMM they share
    (computing the key compiles nothing)."""
    import shutil

    from repro_torch.kernels import build
    split = ["paged_decode_split.cuh", "decode_attention.cuh", "hopper.cuh"]
    includes = {"decode_attention": split,
                "paged_decode_attention": split,
                "paged_prefill_attention": ["decode_attention.cuh",
                                            "hopper.cuh"],
                "paged_verify_attention": split,
                "int8_matmul": ["coded_gemm.cuh", "hopper.cuh"],
                "flash_attention": ["hopper.cuh"],
                "ternary_matmul": ["coded_gemm.cuh", "hopper.cuh"]}
    assert set(build.SOURCES) == set(includes)
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    for name, headers in includes.items():
        assert [p.name for p in build.sources_of(name)] == \
            [f"{name}.cu", *headers]
    for edited in ("decode_attention.cuh", "hopper.cuh",
                   "paged_decode_split.cuh", "coded_gemm.cuh"):
        before = {name: build.library_path(name) for name in build.SOURCES}
        header = csrc / edited
        header.write_text(header.read_text() + "\n// edited\n")
        after = {name: build.library_path(name) for name in build.SOURCES}
        assert all((before[n] != after[n]) == (edited in includes[n])
                   for n in build.SOURCES), edited
    assert all(p.parent == build.BUILD_DIR for p in after.values())
