"""The port's fault injection and its in-tick recovery against the JAX
package, on the CPU (mirror of tests/test_serve_faults.py's TestFaultPlan,
TestChaosMatrix, TestReadbackGuard, TestDeadlinesAndBackpressure and
TestCacheSurgery).

The plan, the injector and the guard config are held to the reference
value for value (the same seeded choices, the same messages);
``corrupt_kv_page`` writes the same bit patterns into the same pages as
the JAX function. The chaos matrix runs the reference's tiny model
(d_model 48, 2 layers, pages of 4, 2 slots) on weights bridged from
``init_lm(PRNGKey(0))``: under ``FaultPlan.single(kind, tick=2, seed=11,
slot=1)`` every transient kind leaves the port's streams equal to its
fault-free run's (which equal the JAX engine's), the pool clean and
NaN-free, and the counts (faults, quarantines, readback retries, recovery
tokens, ticks, host readbacks) equal to the JAX engine's under the same
plan. The JAX engines run at ``decode_kernel=False``, their CPU path, and
are shared by module-scoped fixtures.
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
from repro.serve import faults as jfaults
from repro.serve.engine import Request as JRequest
from repro_torch import bridge
from repro_torch.models import transformer as ttf
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve import faults as tfaults
from repro_torch.serve.engine import Request


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
MATRIX_TICK, MATRIX_SEED, MATRIX_SLOT = 2, 11, 1
# the counts a fault run must share with the JAX engine's
COUNTS = ("faults_injected", "quarantined", "readback_retries",
          "recovery_tokens", "ticks", "shed")


def _jcfg(**kw):
    """tests/test_serve_faults.py::_cfg."""
    return jtf.LMConfig(name="t", d_model=48, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=61, pattern=(jtf.BlockSpec(),),
                        repeats=2, remat="none", vocab_pad_multiple=1, **kw)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params), fp32, bridged."""
    jcfg = _jcfg()
    params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                         dtype=jnp.float32).params
    tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def _run(models, jax_side, plan=None, prompts=PROMPTS, max_tokens=8,
         deadline=None, **kw):
    """Drain ``prompts`` through one engine of either package (the
    reference's ``_run``: 2 slots, max_len 64, paged, pages of 4; ``plan``
    the ``FaultPlan.single`` arguments). Returns the engine, the streams by
    uid and the summary."""
    jcfg, params, tcfg, tparams = models
    kw = {"max_slots": 2, "max_len": 64, "paged": True, "page_size": 4, **kw}
    mod = jfaults if jax_side else tfaults
    kw["faults"] = mod.FaultPlan.single(**plan) if plan else None
    if jax_side:
        eng = JServeEngine(params, jcfg, JServeConfig(decode_kernel=False,
                                                      **kw))
    else:
        eng = ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw))
    for p in prompts:
        eng.submit(p, max_tokens=max_tokens, deadline_ticks=deadline)
    done = eng.run_until_drained(max_ticks=400)
    return eng, {r.uid: list(r.generated) for r in done}, eng.summary()


def _matrix_plan(kind):
    return dict(kind=kind, tick=MATRIX_TICK, seed=MATRIX_SEED,
                slot=MATRIX_SLOT)


@pytest.fixture(scope="module")
def jax_matrix(models):
    """The JAX engine's fault-free run and its run under each transient
    kind: kind (None: fault-free) -> (streams, summary, host readbacks)."""
    out = {}
    for kind in (None,) + tfaults.TRANSIENT_FAULT_KINDS:
        eng, streams, s = _run(models, True,
                               _matrix_plan(kind) if kind else None)
        out[kind] = (streams, s, eng.host_readbacks)
    return out


@pytest.fixture(scope="module")
def port_base(models):
    """The port's fault-free run, with one readback a decode tick (plus
    one an extend call and one a finish)."""
    eng, streams, s = _run(models, False)
    log = eng.metrics_log
    assert eng.host_readbacks == (
        sum(m.active_slots > 0 for m in log)
        + sum(m.prefill_tokens > 0 for m in log) + len(PROMPTS))
    return streams, s, eng.host_readbacks


# -----------------------------------------------------------------------------
# the plan, the injector and the guard, value for value
# -----------------------------------------------------------------------------


def test_constants_equal():
    for name in ("FAULT_KINDS", "TRANSIENT_FAULT_KINDS", "STALL_BASE_S",
                 "GARBLE_VALUE"):
        assert getattr(tfaults, name) == getattr(jfaults, name), name


@pytest.mark.parametrize("seed", [5, 6])
def test_matrix_equal(seed):
    """FaultPlan.matrix over every kind: the same events (tick, kind, slot,
    magnitude, duration) as the reference for the seed; tick 0 never
    fires; seeds 5 and 6 differ."""
    got = tfaults.FaultPlan.matrix(seed=seed, n_ticks=20)
    want = jfaults.FaultPlan.matrix(seed=seed, n_ticks=20)
    assert ([dataclasses.astuple(e) for e in got.events]
            == [dataclasses.astuple(e) for e in want.events])
    assert got == tfaults.FaultPlan.matrix(seed=seed, n_ticks=20)
    assert {e.kind for e in got.events} == set(tfaults.FAULT_KINDS)
    assert all(e.tick >= 1 for e in got.events)
    assert got.max_tick == want.max_tick
    assert (tfaults.FaultPlan.matrix(seed=11 - seed, n_ticks=20).events
            != got.events)


def test_for_tick_and_max_tick():
    plan = tfaults.FaultPlan.single("stall", tick=3)
    assert [e.kind for e in plan.for_tick(3)] == ["stall"]
    assert plan.for_tick(2) == []
    assert plan.max_tick == 3
    assert tfaults.FaultPlan().max_tick == -1


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("bad", [
    dict(kind="cosmic_ray", tick=1), dict(kind="stall", tick=-1)])
def test_event_validation_messages_equal(bad):
    assert (_message(lambda: tfaults.FaultEvent(**bad))
            == _message(lambda: jfaults.FaultEvent(**bad)))


@pytest.mark.parametrize("bad", [
    dict(audit_interval=-1), dict(admit_max_retries=-1),
    dict(admit_backoff=-2), dict(drift_check_interval=-1),
    dict(compact_pause_ticks=-1), dict(spec_backoff_threshold=1.5),
    dict(drift_threshold=-0.1), dict(readback_max_retries=0)])
def test_guard_validation_messages_equal(bad):
    msg = _message(lambda: tfaults.GuardrailConfig(**bad))
    assert msg == _message(lambda: jfaults.GuardrailConfig(**bad))
    assert next(iter(bad)) in msg
    assert (dataclasses.asdict(tfaults.GuardrailConfig())
            == dataclasses.asdict(jfaults.GuardrailConfig()))


@pytest.mark.parametrize("seed", range(6))
def test_garble_picks_equal(seed):
    """The garbled element is the reference's for the seed (one
    default_rng(seed) stream, drawn once a garble), and a retry sees the
    true array."""
    arr = np.zeros((3, 8), np.int32)
    events = tuple(jfaults.FaultEvent(tick=t, kind="readback_garble")
                   for t in range(3))
    picks = []
    for mod in (tfaults, jfaults):
        plan = mod.FaultPlan(seed=seed, events=tuple(
            mod.FaultEvent(tick=e.tick, kind=e.kind) for e in events))
        inj = mod.FaultInjector(plan)
        got = [int(np.flatnonzero(inj.filter_readback(arr, t).reshape(-1)
                                  == mod.GARBLE_VALUE)[0]) for t in range(3)]
        assert inj.filter_readback(arr, 1, attempt=1) is arr
        assert inj.counts["readback_garble"] == 3
        picks.append(got)
    assert picks[0] == picks[1]


def test_readback_drop_retry_model():
    """Only the first attempt of the fault's tick is dropped; a retry, and
    any other tick, sees the true array."""
    arr = np.ones((2, 4), np.int32)
    inj = tfaults.FaultInjector(tfaults.FaultPlan.single("readback_drop",
                                                         tick=0))
    assert inj.filter_readback(arr, tick=0, attempt=0) is None
    assert inj.filter_readback(arr, tick=0, attempt=1) is arr
    assert inj.filter_readback(arr, tick=1, attempt=0) is arr
    assert inj.counts["readback_drop"] == 1 and inj.faults_injected == 1


# -----------------------------------------------------------------------------
# cache surgery
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True])
def test_corrupt_kv_page_equal(int8):
    """The same random pools (a pattern pool of stacked layers and a tail
    pool) in both packages: ``corrupt_kv_page`` poisons the same page of
    every layer's K, NaN (fp32) or the codes XOR 0x55 (int8, which can
    write -128), bit for bit as the JAX function, in place; V and the scale
    pools are untouched."""
    kw = {"tail": (jtf.BlockSpec(),)}
    if int8:
        kw["quant"] = jtf.INT8_QUANT
    jcfg = _jcfg(**kw)
    tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
    jpool = jtf.init_paged_caches(jcfg, 6, 4, jnp.float32)
    tpool = ttf.init_paged_caches(tcfg, 6, 4, torch.float32, device="cpu")
    rng = np.random.default_rng(int8)
    filled = {}
    for name, entry in tpool.items():
        jentry = dict(jpool[name])
        for key in ("kv", "kv_scale"):
            if key not in entry:
                continue
            parts = {}
            for part in ("k", "v"):
                t = getattr(entry[key], part)
                if t.dtype == torch.int8:
                    a = rng.integers(-128, 128, t.shape).astype(np.int8)
                else:
                    a = rng.standard_normal(t.shape).astype(np.float32)
                t.copy_(torch.from_numpy(a))
                parts[part] = jnp.asarray(a)
            jentry[key] = dataclasses.replace(jentry[key], **parts)
        filled[name] = jentry
    before = {name: {key: [np.array(getattr(e[key], p)) for p in "kv"]
                     for key in ("kv", "kv_scale") if key in e}
              for name, e in tpool.items()}
    want = jfaults.corrupt_kv_page(filled, 3)
    assert tfaults.corrupt_kv_page(tpool, 3) is None
    for name, entry in tpool.items():
        got_k = entry["kv"].k.numpy()
        want_k = np.asarray(want[name]["kv"].k)
        np.testing.assert_array_equal(got_k.view(np.uint8)
                                      if int8 else got_k,
                                      want_k.view(np.uint8)
                                      if int8 else want_k)
        page = ((slice(None), 3) if name.startswith("pat") else (3,))
        changed = np.nonzero((got_k != before[name]["kv"][0]).reshape(
            got_k.shape[:2 if name.startswith("pat") else 1] + (-1,)).any(
                -1))
        assert {int(p) for p in changed[-1]} == {3}
        if int8:
            assert (got_k[page] == (before[name]["kv"][0][page]
                                    ^ np.int8(0x55))).all()
        else:
            assert np.isnan(got_k[page]).all()
        np.testing.assert_array_equal(entry["kv"].v.numpy(),
                                      before[name]["kv"][1])
        for key in ("kv_scale",):
            if key in entry:
                for i, p in enumerate("kv"):
                    np.testing.assert_array_equal(
                        getattr(entry[key], p).numpy(),
                        before[name][key][i])


# -----------------------------------------------------------------------------
# the chaos matrix: every transient kind, the fault-free streams
# -----------------------------------------------------------------------------


def test_fault_free_run_equals_jax(models, jax_matrix, port_base):
    """The baseline: the port's fault-free streams, ticks and readbacks are
    the JAX engine's, one readback a tick and no chaos count."""
    streams, s, readbacks = port_base
    want, js, jreadbacks = jax_matrix[None]
    assert streams == want and s["ticks"] == js["ticks"]
    assert readbacks == jreadbacks
    for key in ("faults_injected", "quarantined", "readback_retries",
                "recovery_tokens", "shed", "degraded_ticks"):
        assert s[key] == 0, key


@pytest.mark.parametrize("kind", tfaults.TRANSIENT_FAULT_KINDS)
def test_every_kind_drains_stream_identical(models, jax_matrix, port_base,
                                            kind):
    """Each transient kind at tick 2 (seed 11, slot 1) drains with every
    stream equal to the fault-free run's, a clean audit, no live page and
    no non-finite value in the pool; its counts equal the JAX engine's
    under the same plan. The readback kinds retry without a quarantine;
    the numerics kinds quarantine once."""
    eng, got, s = _run(models, False, _matrix_plan(kind))
    want, js, jreadbacks = jax_matrix[kind]
    assert got == port_base[0] == want, kind
    assert s["faults_injected"] >= 1
    assert eng.pool.audit() == [] and eng.pool.live == 0
    for entry in eng.state.caches.values():
        for t in (entry["kv"].k, entry["kv"].v):
            assert bool(torch.isfinite(t).all()), kind
    for key in COUNTS:
        assert s[key] == js[key], (kind, key)
    assert eng.host_readbacks == jreadbacks
    if kind.startswith("readback"):
        assert s["readback_retries"] >= 1 and s["quarantined"] == 0
    if kind in ("nan_logits", "inf_logits", "kv_bitflip"):
        assert s["quarantined"] == 1 and s["recovery_j"] > 0.0
    # the resident poison buffer is written (copy_) on the logit fault's
    # tick only and zeroed on the device after it; on every other tick it
    # is not touched, so a healthy tick copies nothing from the host
    assert not eng._poison.any()
    assert eng._poison._version == (2 if kind.endswith("_logits") else 0)


@pytest.mark.parametrize("case", [dict(spec_k=4),
                                  dict(spec_k=3, spec_tree_m=3)],
                         ids=["spec", "tree"])
def test_nan_logits_on_spec_and_tree_ticks(models, port_base, case):
    """``nan_logits`` on the speculative and the tree tick: the poison
    reaches every lane (and every branch row) of the victim, which is
    quarantined once; the streams equal the plain engine's fault-free
    ones."""
    eng, got, s = _run(models, False, _matrix_plan("nan_logits"), **case)
    assert got == port_base[0]
    assert s["quarantined"] == 1 and s["faults_injected"] == 1
    assert eng.pool.audit() == [] and eng.pool.live == 0
    flagged = [t for t, m in enumerate(eng.metrics_log) if m.quarantined]
    assert flagged == [MATRIX_TICK]


def test_readback_retry_exhaustion_raises(models):
    """A persistently bad link fails loudly after the retry budget."""
    _, _, tcfg, tparams = models
    eng = ServeEngine(tparams, tcfg, ServeConfig(
        max_slots=2, max_len=64, paged=True, page_size=4, device="cpu",
        faults=tfaults.FaultPlan.single("readback_drop", tick=0),
        guard=tfaults.GuardrailConfig(readback_max_retries=2)))
    eng._injector.filter_readback = lambda arr, tick, attempt=0: None
    eng.submit(PROMPTS[0], max_tokens=4)
    with pytest.raises(RuntimeError, match="readback"):
        eng.run_until_drained(max_ticks=10)
    assert eng.host_readbacks >= 3


def test_process_kill_raises_at_its_tick(models):
    _, _, tcfg, tparams = models
    eng = ServeEngine(tparams, tcfg, ServeConfig(
        max_slots=2, max_len=64, paged=True, page_size=4, device="cpu",
        faults=tfaults.FaultPlan.single("process_kill", tick=3)))
    for p in PROMPTS:
        eng.submit(p, max_tokens=8)
    for _ in range(3):
        eng.step()
    with pytest.raises(tfaults.ProcessKilled, match="tick 3"):
        eng.step()
    assert eng._tick_idx == 3 and eng._injector.counts["process_kill"] == 1


# -----------------------------------------------------------------------------
# deadlines and backpressure
# -----------------------------------------------------------------------------


def test_deadline_sheds_overdue_queue(models):
    """Deadline 1 on 8 requests over 2 slots: the overdue queue is shed,
    every request completes (shed ones with no tokens), shed + finished
    partition the workload, and the shed uids and streams are the JAX
    engine's."""
    prompts = [np.arange(6) + 3 * i for i in range(8)]
    runs = [_run(models, j, prompts=prompts, deadline=1) for j in (True,
                                                                   False)]
    (_, want, js), (eng, got, s) = runs
    assert got == want and len(got) == len(prompts)
    assert s["shed"] == js["shed"] > 0
    assert s["shed_rate"] == pytest.approx(js["shed_rate"])
    assert 0.0 < s["shed_rate"] <= 1.0
    assert eng.n_shed + eng.n_finished_ok == len(prompts)
    assert [m.shed for m in eng.metrics_log] == [
        m.shed for m in runs[0][0].metrics_log]


def test_deadline_sheds_nbest_groups(models):
    """n-best requests past their deadline are shed before their group
    forks: each still completes, with ``n_best`` (empty) streams; the
    admitted group finishes with both of its forks."""
    _, _, tcfg, tparams = models
    eng = ServeEngine(tparams, tcfg, ServeConfig(
        max_slots=2, max_len=64, paged=True, page_size=4, device="cpu"))
    for p in PROMPTS:
        eng.submit(p, max_tokens=4, deadline_ticks=1, n_best=2)
    done = {r.uid: r for r in eng.run_until_drained(max_ticks=100)}
    assert sorted(done) == [1, 2, 3]
    assert [len(s) for s in done[1].nbest] == [4, 4]
    for uid in (2, 3):
        assert done[uid].nbest == [[], []] and done[uid].done
    s = eng.summary()
    assert s["shed"] == 2 and s["forks"] == 1
    assert eng.pool.live == 0 and eng.pool.audit() == []


def test_submit_rejects_bad_deadline(models):
    _, _, tcfg, tparams = models
    eng = ServeEngine(tparams, tcfg, ServeConfig(max_slots=2, max_len=64,
                                                 device="cpu"))
    with pytest.raises(ValueError, match="deadline_ticks"):
        eng.submit(np.arange(4), deadline_ticks=0)


def test_admission_retry_exhaustion_sheds(models):
    """tests/test_serve_faults.py's case: backoff parks the retry, the cap
    (2) sheds on the third deferral, and the next step completes the
    request shed, as the JAX engine does."""
    jcfg, params, tcfg, tparams = models
    guard = dict(admit_max_retries=2, admit_backoff=1)
    kw = dict(max_slots=2, max_len=64, paged=True, page_size=4)
    engines = [
        JServeEngine(params, jcfg, JServeConfig(
            decode_kernel=False, guard=jfaults.GuardrailConfig(**guard),
            **kw)),
        ServeEngine(tparams, tcfg, ServeConfig(
            device="cpu", guard=tfaults.GuardrailConfig(**guard), **kw))]
    seen = []
    for eng, req_cls in zip(engines, (JRequest, Request)):
        req = req_cls(99, np.arange(6), max_tokens=4, submit_tick=0)
        eng._defer_admission(req, [], 0, 0, [])
        assert eng._defer_counts[99] == 1
        assert eng._retry_after[99] > eng._tick_idx
        trail = [dict(eng._retry_after)]
        eng.scheduler.drop(lambda r: True)
        eng._defer_admission(req, [], 0, 0, [])
        trail.append(dict(eng._retry_after))
        eng.scheduler.drop(lambda r: True)
        eng._defer_admission(req, [], 0, 0, [])      # the cap (2) exceeded
        assert req in eng._pending_shed and 99 not in eng._defer_counts
        eng.scheduler.drop(lambda r: True)
        done = eng.step()
        assert [r.uid for r in done] == [99] and done[0].done
        assert done[0].generated == []
        assert eng.summary()["shed"] == 1
        seen.append(trail)
    assert seen[0] == seen[1]


def test_chaos_smoke_tool(capsys):
    """``python -m repro_torch.tools.chaos_smoke``: on the card by default
    (raising without one), and on the CPU with ``--device cpu``, where
    every transient kind drains stream-identical."""
    from repro_torch.tools import chaos_smoke
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            chaos_smoke.main([])
    chaos_smoke.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("identical=True") == len(tfaults.TRANSIENT_FAULT_KINDS)
    assert out.rstrip().endswith("ALL PASS")
