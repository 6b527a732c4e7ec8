"""The port's quarantine-and-retry on the numerics sentinel against the JAX
package on the same bridged fp32 weights and prompts, on the CPU.

A slot whose logits go non-finite makes no progress that tick; the host
scrubs its private storage, releases its pages unpublished and requeues a
continuation at the head of the queue, and the caller sees one stream.
Each test poisons the same storage in both packages at the same tick (the
JAX state through ``repro.serve.faults.corrupt_kv_page``, the port's pools
by the same write from the test) or drains the pool by hand before the
copy-on-write barrier, and holds the port to JAX: identical streams, equal
to the fault-free run's; every StepMetrics field of every tick (wall time
aside; ``quarantined`` and the recovery bills among them) equal to 1e-9
relative; the same quarantine counts at the same tick; scrubbed storage
reading zero; a clean pool. The JAX engines run at
``decode_kernel=False``, their CPU path.
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
from repro.serve.faults import corrupt_kv_page
from repro_torch import bridge
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
    """tests/test_serve_faults.py's model, as tests/test_serve_cow.py's."""
    return jtf.LMConfig(name="t", d_model=48, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=61, pattern=(jtf.BlockSpec(),),
                        repeats=2, remat="none", vocab_pad_multiple=1)


_CACHE = {}


def _engines(**kw):
    """The JAX and the port engine on the same weights and config."""
    if not _CACHE:
        jcfg = _core_cfg()
        params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                             dtype=jnp.float32).params
        tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
        tparams = bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        _CACHE["m"] = (jcfg, params, tcfg, tparams)
    jcfg, params, tcfg, tparams = _CACHE["m"]
    kw = {"max_slots": 3, "max_len": 64, **kw}
    return (JServeEngine(params, jcfg, JServeConfig(decode_kernel=False,
                                                    **kw)),
            ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw)))


def _clean_streams(prompts, max_tokens, n_best=None, **kw):
    """The port's fault-free streams: the greedy streams of the plain,
    speculative and tree ticks are one stream, so the plain paged (or
    dense) engine's serve as every case's."""
    key = (len(prompts), max_tokens, tuple(n_best or ()),
           tuple(sorted(kw.items())))
    if key not in _CACHE:
        (_CACHE[key],) = _drive([_engines(**kw)[1]], prompts, max_tokens,
                                n_best=n_best)
    return _CACHE[key]


BILLED = [f.name for f in dataclasses.fields(StepMetrics)
          if f.name != "wall_s"]
PROMPTS = [np.arange(10) + 3, np.arange(7) + 20, np.arange(13) + 1]


def _streams(done):
    return {uid: ([list(s) for s in r.nbest] if r.nbest is not None
                  else list(r.generated)) for uid, r in done.items()}


def _drive(engines, prompts, max_tokens, before=None, after=None,
           n_best=None):
    """Submit to every engine, then step them together; ``before(tick)``
    and ``after(tick)`` run between steps. Returns each engine's streams."""
    n_best = n_best or [1] * len(prompts)
    for eng in engines:
        for p, n in zip(prompts, n_best):
            eng.submit(np.asarray(p, np.int32), max_tokens=max_tokens,
                       n_best=n)
    done = [{} for _ in engines]
    for tick in range(300):
        if before is not None:
            before(tick)
        for eng, d in zip(engines, done):
            d.update({r.uid: r for r in eng.step()})
        if after is not None:
            after(tick)
        if all(not len(e.scheduler) and all(r is None for r in e.slot_req)
               for e in engines):
            break
    return [_streams(d) for d in done]


def _assert_same_run(je, te, tick, n_quarantined):
    assert len(je.metrics_log) == len(te.metrics_log)
    for t, (jm, tm) in enumerate(zip(je.metrics_log, te.metrics_log)):
        for f in BILLED:
            assert getattr(tm, f) == pytest.approx(getattr(jm, f), rel=1e-9,
                                                   abs=0.0), (t, f)
    for eng in (je, te):
        assert [(t, m.quarantined) for t, m in enumerate(eng.metrics_log)
                if m.quarantined] == [(tick, n_quarantined)]
    js, ts = je.summary(), te.summary()
    assert ts["quarantined"] == js["quarantined"] == n_quarantined
    assert ts["recovery_tokens"] == js["recovery_tokens"] > 0
    for key in ("quarantine_rate", "recovery_j", "recovery_j_per_token"):
        assert ts[key] == pytest.approx(js[key], rel=1e-9), key
    if te.pool is not None:
        assert te.pool.state_dict() == je.pool.state_dict()
        assert te.pool.audit() == [] and te.pool.live == 0


def _poison_port(eng, index):
    """The port's side of ``corrupt_kv_page``: NaN in every layer's K at
    pool page (or dense cache row) ``index``."""
    for key, entry in eng.state.caches.items():
        k = entry["kv"].k
        if key.startswith("pat"):               # stacked layers lead
            k[:, index] = float("nan")
        else:
            k[index] = float("nan")


def _storage(eng, index):
    """K and V of every layer at page (or dense row) ``index``, as numpy."""
    out = []
    for key, entry in eng.state.caches.items():
        for part in (entry["kv"].k, entry["kv"].v):
            part = np.asarray(part)
            out.append(part[:, index] if key.startswith("pat")
                       else part[index])
    return out


def _victim(eng, slot):
    """The slot's private live pages (the JAX injector's candidates) and
    its movable suffix, which quarantine scrubs."""
    ps = eng.scfg.page_size
    pages = eng._slot_pages[slot]
    live = -(-(len(eng.slot_req[slot].prompt) + eng._host_gen[slot]) // ps)
    lo = eng.pool.movable_suffix(pages)
    return [p for j, p in enumerate(pages) if lo <= j < live], pages[lo:]


PAGED_CASES = {"plain": {}, "spec": {"spec_k": 2},
               "tree": {"spec_k": 3, "spec_tree_m": 3}}
POISON_TICK, VICTIM = 2, 1


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_quarantine_matches_jax_and_the_fault_free_run(case):
    """One private K page of slot 1 poisoned with NaN at tick 2 in both
    packages: both quarantine that slot at that tick, scrub its private
    pages to zero and retry it, and every stream equals the fault-free
    run's (on the tree, the flagged slot's branch windows are scrubbed and
    released too)."""
    je, te = _engines(paged=True, page_size=4, **PAGED_CASES[case])
    scrubbed = []

    def before(tick):
        if tick != POISON_TICK:
            return
        jcand, jmov = _victim(je, VICTIM)
        assert _victim(te, VICTIM) == (jcand, jmov) and jcand
        je.state = dataclasses.replace(
            je.state, caches=corrupt_kv_page(je.state.caches, jcand[0]))
        _poison_port(te, jcand[0])
        scrubbed.extend(jmov)

    def after(tick):
        if tick == POISON_TICK:
            for eng in (je, te):
                assert eng.slot_req[VICTIM] is None
                for page in scrubbed:
                    assert all((a == 0).all() for a in _storage(eng, page))

    want, got = _drive([je, te], PROMPTS, 16, before, after)
    assert got == want == _clean_streams(PROMPTS, 16, paged=True,
                                         page_size=4)
    _assert_same_run(je, te, POISON_TICK, 1)


def test_dense_quarantine_matches_jax_and_the_fault_free_run():
    """Slot 1's whole dense cache row poisoned in K at tick 2: the same
    quarantine, the row scrubbed to zero, the same streams and bills."""
    je, te = _engines()

    def before(tick):
        if tick == POISON_TICK:
            je.state = dataclasses.replace(
                je.state, caches=corrupt_kv_page(je.state.caches, VICTIM))
            _poison_port(te, VICTIM)

    def after(tick):
        if tick == POISON_TICK:
            for eng in (je, te):
                assert all((a == 0).all() for a in _storage(eng, VICTIM))

    want, got = _drive([je, te], PROMPTS, 16, before, after)
    assert got == want == _clean_streams(PROMPTS, 16)
    _assert_same_run(je, te, POISON_TICK, 1)


def test_cow_barrier_exhaustion_quarantines_and_spares_the_siblings():
    """An n-best group of 3 (a 10-token prompt: a partial boundary block
    shared at the fork) beside a plain request, prefilled in 4-token
    chunks. Before the fork's tick the pool is drained by hand in both
    packages to the children's two tails plus one page: the parent's
    barrier copy takes that page, and both children find the pool
    exhausted, so their lanes are deactivated and they are quarantined at
    that tick in both. The parent's and the plain request's streams are
    untouched; once the hand-held pages return, the children's retries
    finish, and every stream equals the fault-free run's."""
    kw = dict(paged=True, page_size=4, max_slots=4, prefill_chunk=4)
    je, te = _engines(**kw)
    prompts, n_best = [np.arange(10) + 3, np.arange(7) + 20], [3, 1]
    fork_tick = 2                           # the parent's third chunk
    held = {}

    def before(tick):
        if tick == fork_tick:
            for eng in (je, te):
                held[id(eng)] = eng.pool.alloc(eng.pool.available - 5)
        elif tick == fork_tick + 1:
            for eng in (je, te):
                eng.pool.release_all(held.pop(id(eng)))

    def after(tick):
        if tick == fork_tick:
            for eng in (je, te):
                assert eng.metrics_log[-1].forks == 2
                assert [i for i, r in enumerate(eng.slot_req)
                        if r is not None] == [0, 3]

    want, got = _drive([je, te], prompts, 8, before, after, n_best)
    assert got == want == _clean_streams(prompts, 8, n_best, **kw)
    _assert_same_run(je, te, fork_tick, 2)
    assert te.summary()["forks"] == 2
