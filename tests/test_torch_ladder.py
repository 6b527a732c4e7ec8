"""The port's degradation ladder against the JAX package, on the CPU
(mirror of tests/test_serve_faults.py's TestDegradationLadder, the
auditor's cases of TestChaosMatrix, TestSummaryGuards,
TestPoolInvariantsUnderFaults and the launcher's chaos flags).

The reference's tiny model (d_model 48, 2 layers, pages of 4, 2 slots) on
weights bridged from ``init_lm(PRNGKey(0))``. The spec-k backoff walks k
down on collapsing acceptance with the streams of plain paged decode; the
compaction pause, the pool auditor and the fp fallback behave as the
reference's; the int8 drift rung, under the reference's guard and
``kv_bitflip`` plan, falls back to fp once at 12 tokens a request, with the
JAX engine's streams, degraded ticks and ticks, and not at the reference
test's 8 tokens, in either package: there the flip's only visible token is
request 1's last, emitted on the tick its slot finishes, which the drift
check never sees. The JAX engines run at ``decode_kernel=False`` and are
shared by a module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import transformer as jtf
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import faults as jfaults
from repro_torch import bridge
from repro_torch.serve import PagePool, ServeConfig, ServeEngine
from repro_torch.serve import faults as tfaults
from repro_torch.serve.pages import ROOT
from repro_torch.serve.snapshot import reconcile_ownership


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


PROMPTS = [np.arange(15), np.arange(11) + 7, np.arange(8) + 30]
# the reference test's drift guard and plan
DRIFT_GUARD = dict(drift_check_interval=1, drift_min_checks=1,
                   drift_threshold=0.0, ewma_alpha=0.5)
DRIFT_PLAN = dict(kind="kv_bitflip", tick=2, seed=3)
BACKOFF_GUARD = dict(spec_backoff_threshold=0.9, spec_backoff_window=2)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params), fp32, bridged."""
    jcfg = jtf.LMConfig(name="t", d_model=48, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=61, pattern=(jtf.BlockSpec(),),
                        repeats=2, remat="none", vocab_pad_multiple=1)
    params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                         dtype=jnp.float32).params
    tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def _engine(models, jax_side, plan=None, guard=None, **kw):
    """One engine of either package: the reference's 2 slots, max_len 64,
    paged, pages of 4 (``plan`` the ``FaultPlan.single`` arguments,
    ``guard`` the ``GuardrailConfig`` ones)."""
    jcfg, params, tcfg, tparams = models
    kw = {"max_slots": 2, "max_len": 64, "paged": True, "page_size": 4, **kw}
    mod = jfaults if jax_side else tfaults
    kw["faults"] = mod.FaultPlan.single(**plan) if plan else None
    kw["guard"] = mod.GuardrailConfig(**(guard or {}))
    if jax_side:
        return JServeEngine(params, jcfg, JServeConfig(decode_kernel=False,
                                                       **kw))
    return ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw))


def _drain(eng, max_tokens, prompts=PROMPTS):
    for p in prompts:
        eng.submit(p, max_tokens=max_tokens)
    done = eng.run_until_drained(max_ticks=400)
    return {r.uid: list(r.generated) for r in done}


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engine's ladder runs: the int8 drift rung at 8 and 12
    tokens a request, and the spec-k backoff. Name -> (streams,
    summary)."""
    out = {}
    for n in (8, 12):
        eng = _engine(models, True, DRIFT_PLAN, DRIFT_GUARD, quant="int8")
        out[f"drift{n}"] = (_drain(eng, n), eng.summary())
    eng = _engine(models, True, guard=BACKOFF_GUARD, spec_k=4)
    out["backoff"] = (_drain(eng, 10), eng.summary())
    return out


# -----------------------------------------------------------------------------
# the spec-k backoff
# -----------------------------------------------------------------------------


def test_spec_backoff_on_acceptance_collapse(models, jax_runs):
    """The ngram drafter on these prompts accepts little; with the rung
    armed (threshold 0.9, window 2) spec-k walks down, the streams stay
    plain paged greedy decode's, and the backoffs, the final k, the
    degraded ticks and the ticks are the JAX engine's."""
    eng = _engine(models, False, guard=BACKOFF_GUARD, spec_k=4)
    got = _drain(eng, 10)
    base = _drain(_engine(models, False), 10)
    want, js = jax_runs["backoff"]
    s = eng.summary()
    assert got == base == want
    assert s["spec_backoffs"] >= 1 and s["spec_k_current"] < 4
    assert s["degraded_ticks"] >= 1
    for key in ("spec_backoffs", "spec_k_current", "degraded_ticks",
                "ticks", "spec_draft_tokens", "spec_accepted_tokens"):
        assert s[key] == js[key], key
    assert eng.host_readbacks == sum(
        m.active_slots > 0 for m in eng.metrics_log) + sum(
        m.prefill_tokens > 0 for m in eng.metrics_log) + len(PROMPTS)


def test_spec_backoff_off_by_default(models):
    eng = _engine(models, False, spec_k=4)
    _drain(eng, 10)
    s = eng.summary()
    assert s["spec_backoffs"] == 0 and s["spec_k_current"] == 4
    assert s["degraded_ticks"] == 0


def test_spec_backoff_on_the_tree_tick(models):
    """The rung drives the tree tick too: k walks down there, the streams
    stay plain paged decode's and the pool drains clean."""
    eng = _engine(models, False, guard=BACKOFF_GUARD, spec_k=4,
                  spec_tree_m=3)
    got = _drain(eng, 10)
    assert got == _drain(_engine(models, False), 10)
    s = eng.summary()
    assert s["spec_backoffs"] >= 1 and s["spec_k_current"] < 4
    assert eng.pool.audit() == [] and eng.pool.live == 0


# -----------------------------------------------------------------------------
# the compaction pause and the pool auditor
# -----------------------------------------------------------------------------


def test_compaction_pause_rung(models):
    eng = _engine(models, False, compact_threshold=0.3,
                  guard=dict(stall_factor=2.0, compact_pause_ticks=3))
    for w in (0.01, 0.01, 0.01, 0.01):
        eng._maybe_pause_compaction(w)
    assert eng.compaction_pauses == 0
    eng._maybe_pause_compaction(0.05)       # > 2x the smoothed baseline
    assert eng.compaction_pauses == 1
    assert eng._compact_pause_until > eng._tick_idx
    assert eng._maybe_compact() == 0        # paused: no move attempted


class _Clock:
    """The engine's clock in a test: each reading advances 1 ms and a
    sleep advances by its length, so tick walls do not depend on the
    machine's load."""

    def __init__(self):
        self.now = 0.0
        self.slept = []

    def monotonic(self):
        self.now += 1e-3
        return self.now

    def sleep(self, secs):
        self.slept.append(secs)
        self.now += secs


def test_stall_fault_pauses_compaction(models, monkeypatch):
    """A ``stall`` of magnitude 10 (STALL_BASE_S x 10 = 0.2 s of sleep) on
    a tick whose neighbours take milliseconds trips the rung: one pause for
    ``compact_pause_ticks`` ticks, counted as degraded, the same
    streams."""
    from repro_torch.serve import engine as engine_mod
    clock = _Clock()
    monkeypatch.setattr(engine_mod, "time", clock)
    guard = dict(stall_factor=2.0, compact_pause_ticks=3)
    eng = _engine(models, False, dict(kind="stall", tick=6, magnitude=10),
                  guard, compact_threshold=0.3)
    assert _drain(eng, 8) == _drain(_engine(models, False), 8)
    assert clock.slept == [10 * tfaults.STALL_BASE_S]
    assert eng.metrics_log[6].wall_s > 0.2
    s = eng.summary()
    assert s["compaction_pauses"] == 1 and s["degraded_ticks"] == 3
    assert [t for t, m in enumerate(eng.metrics_log) if m.degraded] == [
        7, 8, 9]


def test_audit_stays_clean_under_faults(models):
    eng = _engine(models, False, dict(kind="kv_bitflip", tick=2),
                  dict(audit_interval=1))
    _drain(eng, 8)
    assert eng.summary()["audit_failures"] == 0 and eng.audit_log == []


def test_audit_stays_clean_under_a_spike(models):
    """A pool spike of half the pool for 4 ticks under admission backoff:
    the auditor (every tick) sees the spike's holds in its reconciliation
    and stays clean; the holds return and the pool drains."""
    eng = _engine(models, False,
                  dict(kind="pool_spike", tick=1, magnitude=16, duration=4),
                  dict(audit_interval=1, admit_max_retries=8,
                       admit_backoff=1))
    assert _drain(eng, 8) == _drain(_engine(models, False), 8)
    s = eng.summary()
    assert s["faults_injected"] == 1 and s["audit_failures"] == 0
    assert eng._spike_holds == [] and eng.pool.live == 0


def test_audit_detects_seeded_violation(models):
    eng = _engine(models, False, guard=dict(audit_interval=1))
    eng.submit(PROMPTS[0], max_tokens=4)
    eng.step()
    # the engine claims a page the pool thinks is free: the ownership
    # reconciliation sees it (recorded, never raised)
    free_page = eng.pool._free[0]
    eng._slot_pages[0].append(free_page)
    eng.step()
    assert eng.audit_failures >= 1
    assert f"page {free_page}: engine holds 1 refs, pool says 0" in " ".join(
        eng.audit_log)
    eng._slot_pages[0].remove(free_page)


# -----------------------------------------------------------------------------
# the int8 drift rung and the fp fallback
# -----------------------------------------------------------------------------


def test_int8_drift_fallback_at_12_tokens(models, jax_runs):
    """The reference's guard and plan at 12 tokens a request: the flipped
    int8 K page is finite garbage the sentinel cannot see; the drift check
    sees request 1's changed token and falls back to fp once. Every request
    completes with 12 tokens; the streams, degraded ticks and ticks are the
    JAX engine's."""
    eng = _engine(models, False, DRIFT_PLAN, DRIFT_GUARD, quant="int8")
    got = _drain(eng, 12)
    want, js = jax_runs["drift12"]
    s = eng.summary()
    assert got == want and all(len(g) == 12 for g in got.values())
    assert eng.fp_fallbacks == s["fp_fallbacks"] == js["fp_fallbacks"] == 1
    for key in ("degraded_ticks", "ticks", "faults_injected",
                "recovery_tokens"):
        assert s[key] == js[key], key
    assert eng.pool.audit() == [] and eng.pool.live == 0
    # the rebuilt runtime serves from the fp oracle: an fp32 pool
    assert eng.state.caches["pat0"]["kv"].k.dtype.is_floating_point
    assert "kv_scale" not in eng.state.caches["pat0"]


def test_int8_drift_no_fallback_at_8_tokens(models, jax_runs):
    """At the reference test's 8 tokens neither package falls back: the
    flip's only visible token is request 1's 8th and last, emitted on the
    tick its slot finishes, and the drift check looks only at live slots.
    The streams are the JAX engine's, that token among them."""
    eng = _engine(models, False, DRIFT_PLAN, DRIFT_GUARD, quant="int8")
    got = _drain(eng, 8)
    want, js = jax_runs["drift8"]
    clean = _drain(_engine(models, False, quant="int8"), 8)
    assert got == want
    assert eng.fp_fallbacks == js["fp_fallbacks"] == 0
    assert eng.summary()["degraded_ticks"] == js["degraded_ticks"] == 0
    assert got[1][:7] == clean[1][:7] and got[1][7] != clean[1][7]
    assert {u: g for u, g in got.items() if u != 1} == {
        u: g for u, g in clean.items() if u != 1}


def test_fp_fallback_requeues_live_slots(models):
    eng = _engine(models, False, quant="int8")
    for p in PROMPTS:
        eng.submit(p, max_tokens=6)
    for _ in range(3):
        eng.step()
    live = [r.uid for r in eng.slot_req if r is not None]
    assert live
    eng._fallback_to_fp()
    assert all(r is None for r in eng.slot_req)
    assert set(live) <= {r.uid for r in eng.scheduler.pending}
    done = eng.run_until_drained(max_ticks=400)
    assert {r.uid: len(r.generated) for r in done} == {1: 6, 2: 6, 3: 6}
    assert eng.fp_fallbacks == 1
    eng._fallback_to_fp()                   # one-way: a second call no-ops
    assert eng.fp_fallbacks == 1
    assert eng.summary()["degraded_ticks"] == len(eng.metrics_log) - 3


# -----------------------------------------------------------------------------
# the pool's invariants across the spike path (hypothesis)
# -----------------------------------------------------------------------------


@settings(max_examples=12, deadline=None)
@given(st.integers(4, 24), st.lists(st.integers(0, 5), min_size=1,
                                    max_size=24),
       st.integers(0, 2 ** 31 - 1))
def test_spike_hold_release_cycle_keeps_audit_clean(num_pages, ops, seed):
    """The pool_spike path is alloc-hold-release interleaved with slot
    traffic and publishes. Whatever the interleaving, ``audit()`` and
    ``reconcile_ownership`` over the slots' lists and the holds stay clean
    at every step, and every page returns once its owners let go."""
    pool = PagePool(num_pages, 4)
    rs = np.random.default_rng(seed)
    pool._free = list(rs.permutation(pool._free))
    holds, slots, pubs = [], [], []
    parent, depth = ROOT, 0
    for op in ops:
        if op == 0:                           # a co-tenant spike
            got = pool.alloc(int(rs.integers(1, 4)))
            if got is not None:
                holds.append(got)
        elif op == 1 and holds:               # the spike expires
            pool.release_all(holds.pop())
        elif op == 2:                         # a slot's admission
            got = pool.alloc(int(rs.integers(1, 3)))
            if got is not None:
                slots.append(got)
        elif op == 3 and slots:               # a quarantine's teardown
            pool.release_all(slots.pop())
        elif op == 4:                         # a healthy finish publishes
            got = pool.alloc(1)
            if got is not None:
                parent = pool.publish(got[0], parent, (depth,) * 4)
                depth += 1
                pubs.append(got)
        elif op == 5:                         # an over-ask fails clean
            before = pool.available
            assert pool.alloc(num_pages + 1) is None
            assert pool.available == before
        assert pool.audit() == []
        assert reconcile_ownership(pool, slots,
                                   [(0, h) for h in holds]) == []
    for owned in holds + slots + pubs:
        pool.release_all(owned)
    assert pool.audit() == [] and pool.live == 0


# -----------------------------------------------------------------------------
# the summary's zero guards and the launcher's flags
# -----------------------------------------------------------------------------


CHAOS_KEYS = ("shed_rate", "quarantine_rate", "recovery_j_per_token",
              "recovery_j", "faults_injected", "quarantined", "shed",
              "degraded_ticks", "readback_retries", "fp_fallbacks",
              "compaction_pauses", "audit_failures")


@pytest.mark.parametrize("kw", [dict(paged=False),
                                dict(paged=True, page_size=4),
                                dict(paged=True, page_size=4, spec_k=2)])
def test_empty_engine_summary_is_all_zeros(models, kw):
    eng = _engine(models, False, **kw)
    s = eng.summary()
    for key in CHAOS_KEYS:
        assert s[key] == 0, key
    assert s["decode_tokens_per_s"] == 0.0


LAUNCH = ["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
          "--requests", "3", "--max-tokens", "4", "--slots", "2",
          "--paged", "--page-size", "4"]


def test_launcher_chaos_flags(capsys):
    """``--fault-kind`` with its tick and seed, and ``--deadline-ticks``:
    the run drains and prints the chaos keys."""
    from repro_torch.launch import serve as launch
    launch.main(LAUNCH + ["--fault-kind", "nan_logits", "--fault-tick", "2",
                          "--fault-seed", "3"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3
    assert "chaos (nan_logits@2): 1 injected, 1 quarantined, 0 shed" in out
    launch.main(LAUNCH + ["--deadline-ticks", "1", "--requests", "6"])
    out = capsys.readouterr().out
    assert out.count("req ") == 6 and '"shed": ' in out


@pytest.mark.parametrize("bad", [
    ["--deadline-ticks", "0"], ["--fault-kind", "stall", "--fault-tick",
                                "-1"],
    ["--fault-kind", "process_kill"], ["--fault-kind", "cosmic_ray"]])
def test_launcher_rejects_bad_chaos_flags(bad, capsys):
    from repro_torch.launch import serve as launch
    with pytest.raises(SystemExit):
        launch.main(LAUNCH + bad)
    err = capsys.readouterr().err
    if "process_kill" in bad:
        assert "requires --checkpoint-dir" in err
