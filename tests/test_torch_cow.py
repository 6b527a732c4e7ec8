"""The port's copy-on-write forks, n-best sampling and tree speculation
against the JAX package on the same bridged fp32 weights and prompts, on
the CPU (mirror of tests/test_serve_cow.py's TestNBestParity and
TestTreeSpec).

On the CPU the port's kernels run their plain versions; K5 at the tree's
rows (three rows a slot over tables that share every page but the write
window) is held against its plain version on the card by chip_smoke.py.
Bounds: greedy streams identical to JAX's and to the port's own plain
paged engine (and its linear speculative one), every StepMetrics field of
every tick (wall time aside) equal to JAX's to 1e-9 relative, the pool's
state equal to JAX's after the drain; the drafter's branches and
``cow_pages`` exactly equal. At temperature > 0 the port does not
reproduce JAX's threefry bits: its forks are held to a clean drain and to
determinism. The JAX engines run at ``decode_kernel=False``, their CPU
path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import spec as jspec
from repro_torch import bridge
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
    """tests/test_serve_cow.py::_cfg."""
    return jtf.LMConfig(name="t", d_model=48, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=61, pattern=(jtf.BlockSpec(),),
                        repeats=2, remat="none", vocab_pad_multiple=1)


_CACHE = {}


def _models():
    """(JAX cfg, JAX params, port cfg, port params), fp32, bridged."""
    if not _CACHE:
        jcfg = _core_cfg()
        params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                             dtype=jnp.float32).params
        tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
        tparams = bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        _CACHE["m"] = (jcfg, params, tcfg, tparams)
    return _CACHE["m"]


BILLED = [f.name for f in dataclasses.fields(StepMetrics)
          if f.name != "wall_s"]
COW_KEYS = ("forks", "cow_copies", "cow_bytes", "fork_saved_bytes",
            "fork_saved_flops", "pool_forked_pages", "pool_cow_copies",
            "decode_tokens", "prefill_tokens")


def _engines(**kw):
    """The JAX and the port engine on the same weights and config, as
    tests/test_serve_cow.py::_paged builds them."""
    jcfg, params, tcfg, tparams = _models()
    kw = {"paged": True, "page_size": 4, "max_slots": 4, "max_len": 64,
          **kw}
    return (JServeEngine(params, jcfg, JServeConfig(decode_kernel=False,
                                                    **kw)),
            ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw)))


def _port(**kw):
    return _engines(**kw)[1]


def _run(eng, prompts, max_tokens, n_best=1):
    """Submit and drain; the requests in submission order, with a clean
    pool."""
    uids = [eng.submit(np.asarray(p, np.int32), max_tokens=max_tokens,
                       n_best=n_best) for p in prompts]
    done = {r.uid: r for r in eng.run_until_drained()}
    assert sorted(done) == uids
    assert eng.pool.audit() == [] and eng.pool.live == 0
    return [done[u] for u in uids]


def _streams(reqs):
    return [[list(s) for s in r.nbest] if r.nbest is not None
            else list(r.generated) for r in reqs]


def _assert_same_run(je, te, keys=COW_KEYS):
    assert len(je.metrics_log) == len(te.metrics_log)
    for tick, (jm, tm) in enumerate(zip(je.metrics_log, te.metrics_log)):
        for f in BILLED:
            assert getattr(tm, f) == pytest.approx(getattr(jm, f), rel=1e-9,
                                                   abs=0.0), (tick, f)
    js, ts = je.summary(), te.summary()
    for key in keys:
        assert ts[key] == pytest.approx(js[key], rel=1e-9), key
    assert te.pool.state_dict() == je.pool.state_dict()


# -----------------------------------------------------------------------------
# The device halves: the tree drafter and cow_pages
# -----------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a))


def test_ngram_draft_tree_equals_jax():
    """Random short-alphabet histories (many matches, fewer than m matches,
    matches near the end) and a no-match row, at pos 0-4 and on to the
    history's end; branch 0 is the linear drafter."""
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 4, (6, 24)).astype(np.int32)
    hist[5] = np.arange(24)                     # no bigram repeats
    for k, m in ((1, 2), (3, 3), (4, 5)):
        for p in (0, 1, 2, 3, 4, 9, 16, 22, 23):
            pos = np.full(6, p, np.int32)
            pos[1] = min(p, 1)
            want = np.asarray(jspec.ngram_draft_tree(
                jnp.asarray(hist), jnp.asarray(pos), k, m))
            got = tspec.ngram_draft_tree(_t(hist).long(), _t(pos).long(),
                                         k, m)
            assert got.shape == (6, m, k)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                got[:, 0].numpy(),
                tspec.ngram_draft(_t(hist).long(), _t(pos).long(), k)
                .numpy())


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_cow_pages_equals_jax(quant):
    """A random pool, copies and table redirects padded with sink->sink
    copies and out-of-range slot ids (which drop), a page-only copy (out-of-
    range slot) and a table-only redirect (sink->sink): pools and table
    exactly equal to JAX's."""
    jcfg, _, tcfg, _ = _models()
    if quant:
        jcfg = dataclasses.replace(jcfg, quant=jtf.INT8_QUANT)
        tcfg = dataclasses.replace(tcfg, quant=ttf.INT8_QUANT)
    npages, ps, nslots, nb = 12, 4, 3, 4
    jc = jtf.init_paged_caches(jcfg, npages, ps, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    jc = jax.tree.map(
        lambda a: jnp.asarray(rng.integers(-100, 100, a.shape)
                              .astype(a.dtype)), jc)
    tc = ttf.init_paged_caches(tcfg, npages, ps, dtype=torch.float32,
                               device="cpu")
    for key, entry in jc.items():
        for name in ("kv", "kv_scale"):
            if name in entry:
                for part in ("k", "v"):
                    getattr(tc[key][name], part).copy_(
                        _t(getattr(entry[name], part)))
    sink = npages
    table = rng.integers(0, npages, (nslots, nb)).astype(np.int32)
    # (src, dst, slot, blk, entry)
    events = np.array([[2, 7, 0, 1, 7], [5, 8, 2, 3, 8],
                       [3, 9, nslots + 1, 0, sink],
                       [sink, sink, 1, 2, 10],
                       [sink, sink, nslots + 1, 0, sink],
                       [sink, sink, nslots + 1, 0, sink]], np.int32).T
    jc2, jpt = jtf.cow_pages(jc, jnp.asarray(table),
                             *map(jnp.asarray, events))
    tpt = _t(table)
    ttf.cow_pages(tc, tpt, *map(lambda a: _t(a).long(), events))
    np.testing.assert_array_equal(tpt.numpy(), np.asarray(jpt))
    for key, entry in jc2.items():
        for name in ("kv", "kv_scale"):
            if name in entry:
                for part in ("k", "v"):
                    np.testing.assert_array_equal(
                        getattr(tc[key][name], part).numpy(),
                        np.asarray(getattr(entry[name], part)))


# -----------------------------------------------------------------------------
# n-best forks
# -----------------------------------------------------------------------------

PROMPTS = [np.arange(10) + 3, np.arange(7) + 20, np.arange(13) + 1]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_nbest_greedy_matches_jax_and_independent_decode(quant):
    """n = 3 on prompts with a partial boundary block: every stream equals
    JAX's n-best streams and the port's own plain paged decode of the
    prompt, ``generated`` is stream 0, and every tick's bills (the fork and
    copy-on-write channels among them) equal JAX's."""
    je, te = _engines(quant=quant)
    want = _streams(_run(je, PROMPTS, 8, n_best=3))
    got = _run(te, PROMPTS, 8, n_best=3)
    assert _streams(got) == want
    plain = _run(_port(quant=quant), PROMPTS, 8)
    for r, p in zip(got, plain):
        assert len(r.nbest) == 3 and r.generated == r.nbest[0]
        assert all(s == p.generated for s in r.nbest)
    _assert_same_run(je, te)
    s = te.summary()
    assert s["forks"] == 2 * len(PROMPTS)
    assert s["cow_copies"] >= 2 * len(PROMPTS) and s["fork_saved_bytes"] > 0


def test_page_aligned_prompt_pays_no_barrier_copy():
    """An 8-token prompt on 4-token pages: the fork shares every committed
    page, the first decode write opens a private tail page, and neither
    package copies a page."""
    je, te = _engines()
    prompts = [np.arange(8) + 5]
    want = _streams(_run(je, prompts, 8, n_best=2))
    got = _run(te, prompts, 8, n_best=2)
    assert _streams(got) == want
    (p,) = _run(_port(), prompts, 8)
    assert got[0].nbest == [p.generated, p.generated]
    _assert_same_run(je, te)
    assert te.summary()["cow_copies"] == 0 == je.summary()["cow_copies"]
    assert te.summary()["forks"] == 1


def test_temperature_forks_drain_clean_and_repeat():
    """Temperature 0.9: the forks drain with a clean pool, each group has
    three non-empty streams, the children draw on their own uids (the
    streams of a group differ), and a second run with the same seed gives
    the same streams."""
    runs = [_streams(_run(_port(temperature=0.9), PROMPTS, 8, n_best=3))
            for _ in range(2)]
    assert runs[0] == runs[1]
    for group in runs[0]:
        assert len(group) == 3 and all(len(s) == 8 for s in group)
    assert any(len({tuple(s) for s in group}) > 1 for group in runs[0])


def test_nbest_validation():
    jcfg, params, tcfg, tparams = _models()
    eng = _port()
    with pytest.raises(ValueError, match="n_best"):
        eng.submit(np.arange(4), n_best=0)
    with pytest.raises(ValueError, match="max_slots"):
        eng.submit(np.arange(4), n_best=5)
    dense = ServeEngine(tparams, tcfg, ServeConfig(device="cpu",
                                                   max_slots=2, max_len=64))
    with pytest.raises(ValueError, match="paged"):
        dense.submit(np.arange(4), n_best=2)
    small = _port(num_pages=4)
    with pytest.raises(ValueError, match="n_best 3"):
        small.submit(np.arange(10), max_tokens=4, n_best=3)


# -----------------------------------------------------------------------------
# Tree speculation
# -----------------------------------------------------------------------------

# tests/test_serve_cow.py::TestTreeSpec.REP: repetitive prompts, so the
# ngram drafter finds matches and the trees branch; then short-alphabet
# prompts on three slots where a later match's branch wins some ticks
TREE_CASES = {
    "repetitive": ([np.tile([5, 9, 5, 9, 5], 4), np.tile([3, 4, 4, 3], 5),
                    np.arange(11) + 2], 2, 10),
    "branching": ([[3, 1, 1, 3, 3, 3, 1, 2, 3, 2, 3, 2, 2, 1, 3, 0, 2, 2, 3],
                   [1, 1, 1, 1, 2, 3, 0, 3, 2, 1, 2, 2, 1, 1, 2, 2, 2, 1],
                   [1, 1, 3, 1, 0, 2, 2, 0, 0, 1, 3, 1, 3, 1, 0, 3, 3, 0, 0,
                    2, 1]], 3, 12),
}


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_tree_matches_jax_plain_and_linear(case, quant):
    """k = 3, m = 3: the tree streams equal JAX's tree streams, the port's
    plain paged streams and its linear speculative streams; the accepted
    tokens per tick equal JAX's and are at least linear speculation's
    (above it where a later branch wins: its window pages are adopted);
    every tick's bills equal JAX's."""
    prompts, slots, max_tokens = TREE_CASES[case]
    je, te = _engines(max_slots=slots, quant=quant, spec_k=3,
                      spec_tree_m=3)
    want = _streams(_run(je, prompts, max_tokens))
    assert _streams(_run(te, prompts, max_tokens)) == want
    assert _streams(_run(_port(max_slots=slots, quant=quant), prompts,
                         max_tokens)) == want
    linear = _port(max_slots=slots, quant=quant, spec_k=3)
    assert _streams(_run(linear, prompts, max_tokens)) == want
    _assert_same_run(je, te, keys=COW_KEYS + ("accepted_tokens_per_tick",
                                              "spec_accepted_tokens"))
    tree_rate = te.summary()["accepted_tokens_per_tick"]
    linear_rate = linear.summary()["accepted_tokens_per_tick"]
    assert tree_rate >= linear_rate
    if case == "branching":
        assert tree_rate > linear_rate
    assert te.summary()["cow_copies"] > 0   # the branches' boundary copies


def test_launcher_nbest_and_tree_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    base = ["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
            "--requests", "2", "--max-tokens", "4", "--slots", "3",
            "--paged", "--page-size", "4"]
    launch.main(base + ["--nbest", "3"])
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and out.count("nbest[2]") == 2
    assert "copy-on-write: 4 forks" in out
    launch.main(base + ["--spec-k", "3", "--spec-tree-m", "3"])
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and "accept rate" in out
    for bad in (["--nbest", "0"], ["--nbest", "4"],
                ["--spec-tree-m", "2"],
                ["--spec-k", "2", "--spec-tree-m", "2", "--spec-drafter",
                 "oracle"]):
        with pytest.raises(SystemExit):
            launch.main(base + bad)
    with pytest.raises(SystemExit):
        launch.main(base[:-3] + ["--nbest", "2"])     # not paged
