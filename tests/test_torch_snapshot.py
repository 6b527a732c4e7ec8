"""The port's durability tier on the CPU (mirror of
tests/test_serve_snapshot.py): the write-ahead journal, crash-consistent
snapshots, restore with journal replay and a surviving ``process_kill``.

Against the JAX package, on the reference's tiny model (d_model 48, 2
layers, pages of 4, 2 slots) with weights bridged from
``init_lm(PRNGKey(0))``: the same durable run writes a byte-identical
``journal.jsonl`` in both packages, and after it both engines'
``host_state_dict`` agree on every key but three that depend on wall time
or the snapshot file's size (``metrics_log[*].wall_s``, the wall EWMA,
``durability.snapshot_bytes_total``); the billed floats of ``metrics_log``
to 1e-9 relative, everything else exactly. The JAX engine runs once, at
``decode_kernel=False`` (its CPU path), in a module-scoped fixture.

Against the port's own uncrashed run (``TestRestoreEquivalence``): each of
the reference's five modes (plain, int8, spec, nbest, chunk), the dense
engine and an int8 engine whose fp fallback was forced before its last
snapshot crash, restore from disk and drain to the same streams, the
reference's counters and a clean pool. The helper drains the restored
engine only while it holds work: ``run_until_drained`` steps once before it
looks, so draining an engine that restored an already drained run adds an
idle tick (the outcome the reference's own property test trips on, pinned
here by ``test_drained_restore_then_drain_adds_an_idle_tick``).
"""

import dataclasses
import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import transformer as jtf
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import snapshot as jsnap
from repro_torch import bridge
from repro_torch.checkpoint.manager import tree_checksum
from repro_torch.core import accounting
from repro_torch.models import costing
from repro_torch.serve import (FaultEvent, FaultPlan, Journal, ProcessKilled,
                               ServeConfig, ServeEngine)
from repro_torch.serve import snapshot as tsnap

PROMPTS = [np.arange(15), np.arange(11) + 7, np.arange(8) + 30]
LONG_PROMPTS = [np.arange(40) % 50, (np.arange(36) + 3) % 50]

# the reference's serving-mode matrix: (ServeConfig overrides, prompts,
# submit kwargs)
MODES = {
    "plain": (dict(), PROMPTS, dict(max_tokens=8)),
    "int8": (dict(quant="int8"), PROMPTS, dict(max_tokens=8)),
    "spec": (dict(spec_k=2), PROMPTS, dict(max_tokens=8)),
    "nbest": (dict(max_slots=4, num_pages=64, temperature=0.7),
              [np.arange(18), np.arange(12) + 5],
              dict(max_tokens=8, n_best=2)),
    "chunk": (dict(max_len=128, num_pages=80, prefill_chunk=8),
              LONG_PROMPTS, dict(max_tokens=6)),
    # the port's extra case: the dense engine
    "dense": (dict(paged=False), PROMPTS, dict(max_tokens=8)),
}

# counters that must match the continuous run exactly after a restore
EQUIV_KEYS = ("ticks", "decode_tokens", "prefill_tokens",
              "prefix_hit_tokens", "shed", "quarantined", "forks",
              "cow_copies")

DURABILITY_KEYS = ("snapshots_taken", "snapshot_bytes", "journal_bytes",
                   "replayed_ticks", "restore_j", "restore_j_per_token",
                   "durability_write_j")

# host_state_dict values that depend on wall time or the file format
WALL_OR_FORMAT = {("ewmas", "wall"),
                  ("durability", "snapshot_bytes_total")}


_MODELS = []


def _models():
    """(JAX cfg, JAX params, port cfg, port params), fp32, bridged; built
    once (hypothesis's examples take no fixture)."""
    if not _MODELS:
        jcfg = jtf.LMConfig(name="t", d_model=48, n_heads=4, n_kv_heads=2,
                            d_ff=96, vocab=61, pattern=(jtf.BlockSpec(),),
                            repeats=2, remat="none", vocab_pad_multiple=1)
        params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                             dtype=jnp.float32).params
        tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
        tparams = bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        _MODELS.append((jcfg, params, tcfg, tparams))
    return _MODELS[0]


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny model's ops are far below any parallel grain, but on a
    loaded host (the suite's parallel workers) idle intra-op threads cost
    this file several times its run time: one thread while it runs, the
    worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _base(over, kw):
    base = dict(max_slots=2, max_len=64, paged=True, page_size=4, seed=0)
    base.update(over)
    base.update(kw)
    return base


def _scfg(over, **kw):
    """The reference test's ``_scfg`` on the port's CPU."""
    return ServeConfig(device="cpu", **_base(over, kw))


def _engine(models, scfg, **kw):
    return ServeEngine(models[3], models[2], scfg, **kw)


def _streams(reqs):
    return {r.uid: (list(r.generated),
                    ([[int(t) for t in s] for s in r.nbest]
                     if r.nbest is not None else None)) for r in reqs}


def _submit_all(eng, prompts, sub_kw):
    for p in prompts:
        eng.submit(p, **sub_kw)


def _has_work(eng):
    return len(eng.scheduler) or any(r is not None for r in eng.slot_req)


_BASELINES = {}


def _baseline(models, mode):
    """The port's continuous (checkpoint-free) run of a mode, cached."""
    if mode not in _BASELINES:
        over, prompts, sub_kw = MODES[mode]
        eng = _engine(models, _scfg(over))
        _submit_all(eng, prompts, sub_kw)
        done = eng.run_until_drained(max_ticks=400)
        _BASELINES[mode] = (_streams(done), eng.summary())
    return _BASELINES[mode]


def _assert_clean(eng):
    if eng.pool is not None:
        assert eng.pool.audit() == [] and eng.pool.live == 0


def _crash(models, scfg, prompts, sub_kw, n_ticks, prepare=None):
    """A durable engine stepped ``n_ticks`` ticks (fewer if it drains),
    then dropped: the simulated crash. ``prepare(eng, tick)`` runs before
    each tick."""
    eng = _engine(models, scfg)
    _submit_all(eng, prompts, sub_kw)
    for t in range(n_ticks):
        if prepare is not None:
            prepare(eng, t)
        eng.step()
        if not _has_work(eng):
            break


def _restore_check(models, mode, n_ticks, tmpdir, interval=2):
    """Run a durable engine ``n_ticks`` ticks, drop it, restore a fresh
    engine from disk, drain it while it holds work, and hold its streams
    and counters to the continuous run's."""
    over, prompts, sub_kw = MODES[mode]
    want, want_s = _baseline(models, mode)
    d = os.path.join(str(tmpdir), f"{mode}_{n_ticks}_{interval}")
    scfg = _scfg(over, checkpoint_dir=d, checkpoint_interval=interval)
    _crash(models, scfg, prompts, sub_kw, n_ticks)
    eng2 = _engine(models, scfg)
    got = _streams(eng2.restore())
    if _has_work(eng2):
        got.update(_streams(eng2.run_until_drained(max_ticks=400)))
    assert got == want, (mode, n_ticks, interval)
    s = eng2.summary()
    for key in EQUIV_KEYS:
        if key in want_s:
            assert s[key] == want_s[key], (mode, n_ticks, interval, key)
    _assert_clean(eng2)
    return eng2


# -----------------------------------------------------------------------------
# Cross-package parity: the JAX engine against the port
# -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_durable(models, tmp_path_factory):
    """The JAX engine's durable plain run (interval 2, 5 ticks): its
    journal's bytes, its host state and its config fingerprint."""
    jcfg, params = models[0], models[1]
    d = str(tmp_path_factory.mktemp("jax_durable"))
    scfg = JServeConfig(decode_kernel=False, checkpoint_dir=d,
                        checkpoint_interval=2, **_base({}, {}))
    eng = JServeEngine(params, jcfg, scfg)
    _submit_all(eng, PROMPTS, dict(max_tokens=8))
    for _ in range(5):
        eng.step()
    with open(os.path.join(d, "journal.jsonl"), "rb") as f:
        journal = f.read()
    return journal, jsnap.host_state_dict(eng), jsnap.config_fingerprint(
        scfg)


@pytest.fixture(scope="module")
def port_durable(models, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_durable"))
    scfg = _scfg({}, checkpoint_dir=d, checkpoint_interval=2)
    eng = _engine(models, scfg)
    _submit_all(eng, PROMPTS, dict(max_tokens=8))
    for _ in range(5):
        eng.step()
    with open(os.path.join(d, "journal.jsonl"), "rb") as f:
        journal = f.read()
    return journal, tsnap.host_state_dict(eng), tsnap.config_fingerprint(
        scfg)


def test_journal_bytes_identical_to_jax(jax_durable, port_durable):
    assert port_durable[0] == jax_durable[0]
    assert port_durable[0].count(b'"kind": "submit"') == len(PROMPTS)
    assert port_durable[0].count(b'"kind": "tick"') == 5


def test_config_fingerprint_identical_to_jax(jax_durable, port_durable):
    assert port_durable[2] == jax_durable[2]
    assert port_durable[2]["cache_dtype"] == "float32"
    bf = ServeConfig(cache_dtype=torch.bfloat16, device="cpu")
    assert tsnap.config_fingerprint(bf)["cache_dtype"] == "bfloat16"


def _assert_state_equal(got, want, path=()):
    """``got == want`` on every leaf; a float of ``metrics_log`` to 1e-9
    relative, the WALL_OR_FORMAT leaves and ``metrics_log[*].wall_s``
    skipped."""
    if path in WALL_OR_FORMAT:
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(set(got) ^ set(want)))
        for key in want:
            _assert_state_equal(got[key], want[key], path + (key,))
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            sub = path + (i,)
            if path == ("metrics_log",):
                assert set(g) == set(w), sub
                for field in w:
                    if field == "wall_s":
                        continue
                    if isinstance(w[field], float):
                        assert g[field] == pytest.approx(
                            w[field], rel=1e-9, abs=0.0), sub + (field,)
                    else:
                        assert g[field] == w[field], sub + (field,)
            else:
                _assert_state_equal(g, w, sub)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_host_state_dict_equal_to_jax(jax_durable, port_durable):
    got, want = port_durable[1], jax_durable[1]
    assert got["tick_idx"] == 5 and got["durability"]["snapshots_taken"] == 2
    _assert_state_equal(got, want)
    # the state is what the manifest's checksum hashes: plain JSON
    assert json.loads(json.dumps(got, sort_keys=True)) == got


# -----------------------------------------------------------------------------
# Restore equivalence: the port against its own uncrashed run
# -----------------------------------------------------------------------------


class TestRestoreEquivalence:
    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_mid_run_restore_matches_continuous(self, models, mode, tmpdir):
        eng2 = _restore_check(models, mode, n_ticks=3, tmpdir=tmpdir)
        assert eng2.replayed_ticks == 1          # snapshot at 2, crash at 3

    def test_int8_restore_after_fp_fallback(self, models, tmpdir):
        """An int8 engine whose fp fallback is forced before tick 2: the
        snapshot at tick 4 holds the fp runtime, so restore rebuilds it
        before loading, and the streams are those of the same forced run
        without a crash."""
        over, prompts, sub_kw = MODES["int8"]

        def force(eng, t):
            if t == 2:
                eng._fallback_to_fp()

        cont = _engine(models, _scfg(over))
        _submit_all(cont, prompts, sub_kw)
        done = []
        for t in range(400):
            force(cont, t)
            done += cont.step()
            if not _has_work(cont):
                break
        want = _streams(done)
        d = os.path.join(str(tmpdir), "fallback")
        scfg = _scfg(over, checkpoint_dir=d, checkpoint_interval=2)
        _crash(models, scfg, prompts, sub_kw, 5, prepare=force)
        eng2 = _engine(models, scfg)
        assert eng2.state.caches["pat0"]["kv"].k.dtype == torch.int8
        got = _streams(eng2.restore())
        assert eng2._fell_back and eng2.fp_fallbacks == 1
        assert eng2.state.caches["pat0"]["kv"].k.dtype == torch.float32
        assert "kv_scale" not in eng2.state.caches["pat0"]
        got.update(_streams(eng2.run_until_drained(max_ticks=400)))
        assert got == want
        assert eng2.summary()["ticks"] == cont.summary()["ticks"]
        _assert_clean(eng2)

    def test_restore_before_any_snapshot_replays_journal_only(
            self, models, tmpdir):
        eng2 = _restore_check(models, "plain", n_ticks=1, tmpdir=tmpdir,
                              interval=100)
        assert eng2.snapshots_taken == 0 and eng2.replayed_ticks == 1

    def test_restore_journal_only_mode(self, models, tmpdir):
        eng2 = _restore_check(models, "plain", n_ticks=4, tmpdir=tmpdir,
                              interval=0)
        assert eng2.replayed_ticks == 4

    def test_restore_after_drain_returns_everything(self, models, tmpdir):
        want, _ = _baseline(models, "plain")
        d = os.path.join(str(tmpdir), "drained")
        scfg = _scfg({}, checkpoint_dir=d, checkpoint_interval=2)
        eng = _engine(models, scfg)
        _submit_all(eng, PROMPTS, dict(max_tokens=8))
        eng.run_until_drained(max_ticks=400)
        eng2 = _engine(models, scfg)
        assert _streams(eng2.restore()) == want
        assert eng2.run_until_drained(max_ticks=10) == []

    @settings(max_examples=8, deadline=None)
    @given(st.integers(1, 10), st.sampled_from(sorted(MODES)),
           st.sampled_from((1, 2, 3)))
    def test_restore_at_arbitrary_tick(self, n_ticks, mode, interval):
        """For any (crash tick, mode, snapshot interval), restore and a
        drain of what is left give the continuous run's streams and
        counters."""
        d = tempfile.mkdtemp(prefix="snap_hyp.")
        try:
            _restore_check(_models(), mode, n_ticks, d, interval=interval)
        finally:
            shutil.rmtree(d, ignore_errors=True)

    def test_drained_restore_then_drain_adds_an_idle_tick(self, models,
                                                          tmpdir):
        """The spec mode drains in 6 ticks; a crash after those 6 ticks
        (snapshot every tick) restores a drained engine, and
        ``run_until_drained`` steps once before it looks: 7 ticks, the JAX
        engine's own outcome in its property test. The streams are the
        continuous run's."""
        over, prompts, sub_kw = MODES["spec"]
        want, want_s = _baseline(models, "spec")
        assert want_s["ticks"] == 6
        d = os.path.join(str(tmpdir), "idle")
        scfg = _scfg(over, checkpoint_dir=d, checkpoint_interval=1)
        _crash(models, scfg, prompts, sub_kw, 6)
        eng2 = _engine(models, scfg)
        got = _streams(eng2.restore())
        assert eng2.summary()["ticks"] == 6 and not _has_work(eng2)
        assert eng2.run_until_drained(max_ticks=400) == []
        assert got == want and eng2.summary()["ticks"] == 7

    def test_restore_requires_fresh_engine(self, models, tmpdir):
        scfg = _scfg({}, checkpoint_dir=str(tmpdir), checkpoint_interval=2)
        eng = _engine(models, scfg)
        eng.submit(PROMPTS[0], max_tokens=4)
        eng.step()
        with pytest.raises(RuntimeError, match="fresh engine"):
            eng.restore()

    def test_restore_requires_checkpoint_dir(self, models):
        eng = _engine(models, _scfg({}))
        with pytest.raises(RuntimeError, match="checkpoint_dir"):
            eng.restore()


# -----------------------------------------------------------------------------
# process_kill: kill, restart, the same streams
# -----------------------------------------------------------------------------


def _h100_accountant():
    return accounting.CarbonAccountant(accounting.AccountantConfig(
        device="h100_sxm", n_devices=1, grid_mix="NY"))


class TestProcessKill:
    def test_kill_restore_drain_identical(self, models, tmpdir):
        want, _ = _baseline(models, "plain")
        d = os.path.join(str(tmpdir), "kill")
        scfg = _scfg(dict(faults=FaultPlan.single("process_kill", tick=7,
                                                  seed=3)),
                     checkpoint_dir=d, checkpoint_interval=2)
        eng = _engine(models, scfg)
        _submit_all(eng, PROMPTS, dict(max_tokens=8))
        with pytest.raises(ProcessKilled, match="tick 7"):
            eng.run_until_drained(max_ticks=400)
        assert eng._injector.counts["process_kill"] == 1
        acct = _h100_accountant()
        eng2 = _engine(models, scfg, accountant=acct)
        got = _streams(eng2.restore())
        got.update(_streams(eng2.run_until_drained(max_ticks=400)))
        assert got == want
        s = eng2.summary()
        # kill at tick 7, snapshots every 2: the latest covers ticks 0-5,
        # so replay repeats tick 6, billed as restore_j
        assert s["replayed_ticks"] == 1
        assert s["restore_j"] > 0.0 and s["restore_j_per_token"] > 0.0
        assert s["snapshots_taken"] > 0
        assert s["journal_bytes"] > 0.0 and s["durability_write_j"] > 0.0
        rep = acct.report()
        assert rep["replayed_ticks"] == 1
        assert rep["restore_j"] > 0.0
        _assert_clean(eng2)

    def test_restored_kill_does_not_refire(self, models, tmpdir):
        """The restart carries the same plan: the kill at or before the
        restore boundary does not fire again, a later one does, and a
        second restore survives it too."""
        want, _ = _baseline(models, "plain")
        d = os.path.join(str(tmpdir), "kill2")
        plan = FaultPlan(seed=3, events=(
            FaultEvent(tick=4, kind="process_kill"),
            FaultEvent(tick=8, kind="process_kill")))
        scfg = _scfg(dict(faults=plan), checkpoint_dir=d,
                     checkpoint_interval=2)
        eng = _engine(models, scfg)
        _submit_all(eng, PROMPTS, dict(max_tokens=8))
        with pytest.raises(ProcessKilled, match="tick 4"):
            eng.run_until_drained(max_ticks=400)
        eng2 = _engine(models, scfg)
        got = _streams(eng2.restore())
        assert eng2._restore_boundary == 4
        with pytest.raises(ProcessKilled, match="tick 8"):
            eng2.run_until_drained(max_ticks=400)
        eng3 = _engine(models, scfg)
        got.update(_streams(eng3.restore()))
        got.update(_streams(eng3.run_until_drained(max_ticks=400)))
        assert got == want
        _assert_clean(eng3)

    def test_injector_rng_survives_the_kill(self, models, tmpdir):
        """Garbled readbacks before and after a kill: the restored
        injector continues the dead one's random stream, so the retries,
        the streams and the injector's final RNG state are those of the
        same plan without the kill."""
        garbles = (FaultEvent(tick=2, kind="readback_garble"),
                   FaultEvent(tick=6, kind="readback_garble"))
        plain = FaultPlan(seed=5, events=garbles)
        killed = FaultPlan(seed=5, events=garbles + (
            FaultEvent(tick=5, kind="process_kill"),))
        cont = _engine(models, _scfg(dict(faults=plain)))
        _submit_all(cont, PROMPTS, dict(max_tokens=8))
        want = _streams(cont.run_until_drained(max_ticks=400))
        d = os.path.join(str(tmpdir), "garble")
        scfg = _scfg(dict(faults=killed), checkpoint_dir=d,
                     checkpoint_interval=2)
        eng = _engine(models, scfg)
        _submit_all(eng, PROMPTS, dict(max_tokens=8))
        with pytest.raises(ProcessKilled):
            eng.run_until_drained(max_ticks=400)
        eng2 = _engine(models, scfg)
        got = _streams(eng2.restore())
        got.update(_streams(eng2.run_until_drained(max_ticks=400)))
        assert got == want
        s, cs = eng2.summary(), cont.summary()
        assert s["readback_retries"] == cs["readback_retries"] == 2
        assert (eng2._injector._rng.bit_generator.state
                == cont._injector._rng.bit_generator.state)


# -----------------------------------------------------------------------------
# Integrity gates: corrupted and inconsistent snapshots refuse
# -----------------------------------------------------------------------------


def _latest_ckpt_dir(checkpoint_dir):
    snaps = os.path.join(checkpoint_dir, "snapshots")
    return os.path.join(snaps, sorted(os.listdir(snaps))[-1])


def _durable_run(models, tmpdir, name):
    d = os.path.join(str(tmpdir), name)
    scfg = _scfg({}, checkpoint_dir=d, checkpoint_interval=2)
    eng = _engine(models, scfg)
    _submit_all(eng, PROMPTS, dict(max_tokens=8))
    for _ in range(5):
        eng.step()
    return scfg, d


class TestIntegrityGates:
    def test_bitflip_in_arrays_refuses(self, models, tmpdir):
        scfg, d = _durable_run(models, tmpdir, "bitrot")
        path = os.path.join(_latest_ckpt_dir(d), "arrays.npz")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
        eng2 = _engine(models, scfg)
        # the zip layer's CRC or the manifest checksum: either way the
        # corrupt snapshot never installs
        with pytest.raises(Exception):
            eng2.restore()
        assert eng2._tick_idx == 0 and not eng2.metrics_log

    def test_tampered_extra_fails_checksum(self, models, tmpdir):
        scfg, d = _durable_run(models, tmpdir, "tamper")
        mpath = os.path.join(_latest_ckpt_dir(d), "manifest.json")
        with open(mpath) as f:
            man = json.load(f)
        man["extra"]["tick_idx"] += 1          # doctored, not re-signed
        with open(mpath, "w") as f:
            json.dump(man, f)
        with pytest.raises(RuntimeError, match="integrity check"):
            _engine(models, scfg).restore()

    def test_resigned_inconsistent_snapshot_names_invariant(
            self, models, tmpdir):
        """A tamper that re-signs the checksum passes the digest; the
        ownership reconciliation the auditor shares still refuses it and
        names the violation."""
        scfg, d = _durable_run(models, tmpdir, "resign")
        ck = _latest_ckpt_dir(d)
        mpath = os.path.join(ck, "manifest.json")
        with open(mpath) as f:
            man = json.load(f)
        held = next(pages[0] for pages in man["extra"]["slot_pages"]
                    if pages)                  # a page the engine holds
        man["extra"]["pool"]["ref"][held] = 0  # that the pool forgets
        with np.load(os.path.join(ck, "arrays.npz")) as arrays:
            named = [(n, arrays[n]) for n in man["names"]]
        man["checksum"] = tree_checksum(named, man["extra"], man["dtypes"])
        with open(mpath, "w") as f:
            json.dump(man, f)
        with pytest.raises(RuntimeError,
                           match="consistency check.*pool says"):
            _engine(models, scfg).restore()

    def test_config_fingerprint_mismatch_refuses(self, models, tmpdir):
        _, d = _durable_run(models, tmpdir, "fprint")
        other = _scfg(dict(page_size=8, checkpoint_dir=d,
                           checkpoint_interval=2))
        with pytest.raises(RuntimeError, match="page_size"):
            _engine(models, other).restore()


# -----------------------------------------------------------------------------
# Journal: the write-ahead contract, torn tails, replay divergence
# -----------------------------------------------------------------------------


class TestJournal:
    def test_round_trip_and_seq(self, tmpdir):
        path = os.path.join(str(tmpdir), "j.jsonl")
        j = Journal(path)
        n1 = j.append_submit(uid=1, prompt=[1, 2], max_tokens=4,
                             temperature=None, deadline_ticks=None,
                             n_best=1, tick=0)
        n2 = j.append_tick(tick=0, finished=[[1, [5, 6], None]])
        assert n1 > 0 and n2 > 0
        assert j.bytes_written == n1 + n2
        recs = j.records()
        assert [r["seq"] for r in recs] == [0, 1]
        assert recs[0]["kind"] == "submit" and recs[1]["kind"] == "tick"
        j.close()

    def test_torn_tail_truncated_on_open(self, tmpdir):
        path = os.path.join(str(tmpdir), "j.jsonl")
        j = Journal(path)
        j.append_submit(uid=1, prompt=[1], max_tokens=4, temperature=None,
                        deadline_ticks=None, n_best=1, tick=0)
        j.append_tick(tick=0, finished=[])
        j.close()
        with open(path, "a") as f:
            f.write('{"kind": "tick", "tick": 1, "fini')   # torn write
        j2 = Journal(path)
        recs = j2.records()
        assert len(recs) == 2                  # the torn record dropped
        assert j2.seq == 2                     # the next seq continues
        with open(path) as f:
            assert f.read().endswith("\n")     # the file truncated
        j2.close()

    def test_replay_divergence_raises(self, models, tmpdir):
        """A journal whose recorded emissions cannot be reproduced (one
        emitted token flipped) refuses: serving other streams after a
        recovery is the failure the check exists for."""
        d = os.path.join(str(tmpdir), "diverge")
        scfg = _scfg({}, checkpoint_dir=d, checkpoint_interval=0)
        eng = _engine(models, scfg)
        _submit_all(eng, PROMPTS, dict(max_tokens=8))
        eng.run_until_drained(max_ticks=400)
        jpath = os.path.join(d, "journal.jsonl")
        with open(jpath) as f:
            recs = [json.loads(ln) for ln in f]
        for r in recs:
            if r["kind"] == "tick" and r["finished"]:
                r["finished"][0][1][0] ^= 1    # flip one emitted token
                break
        with open(jpath, "w") as f:
            for r in recs:
                f.write(json.dumps(r, sort_keys=True) + "\n")
        with pytest.raises(RuntimeError, match="replay diverged"):
            _engine(models, scfg).restore()


# -----------------------------------------------------------------------------
# Zero-state guards and the costing helpers
# -----------------------------------------------------------------------------


class TestZeroStateGuards:
    def test_engine_summary_durability_zeros(self, models):
        for over in ({}, dict(paged=False)):
            s = _engine(models, _scfg(over)).summary()
            for key in DURABILITY_KEYS:
                assert s[key] == 0.0, key

    def test_accountant_report_durability_zeros(self):
        rep = _h100_accountant().report()
        for key in DURABILITY_KEYS:
            assert rep[key] == 0.0, key

    def test_accountant_state_round_trip(self):
        a = _h100_accountant()
        a.observe_step(0.5, n_tokens=10)
        a.observe_durability(snapshot_bytes=100.0, journal_bytes=7.0,
                             restore_flops=2.0, restore_bytes=3.0,
                             replayed_ticks=1, snapshots=1)
        b = _h100_accountant()
        b.load_state(json.loads(json.dumps(a.state_dict())))
        ra, rb = a.report(), b.report()
        for key in ("tokens", "steps", "snapshots_taken", "snapshot_bytes",
                    "journal_bytes", "replayed_ticks", "restore_j",
                    "durability_write_j"):
            assert ra[key] == rb[key], key

    def test_engine_rejects_bad_checkpoint_config(self, models):
        with pytest.raises(ValueError, match="checkpoint_interval"):
            _engine(models, _scfg(dict(checkpoint_interval=-1)))
        with pytest.raises(ValueError, match="checkpoint_dir"):
            _engine(models, _scfg(dict(checkpoint_interval=2)))


class TestDurabilityCosting:
    def test_expected_replay_ticks(self):
        assert costing.expected_replay_ticks(0) == 0.0
        assert costing.expected_replay_ticks(1) == 0.0
        assert costing.expected_replay_ticks(5) == 2.0

    def test_overhead_bytes_per_tick_tradeoff(self):
        # a shorter interval writes more and replays less
        hi = costing.durability_overhead_bytes_per_tick(1000.0, 10.0, 2)
        lo = costing.durability_overhead_bytes_per_tick(1000.0, 10.0, 10)
        assert hi > lo
        assert costing.durability_overhead_bytes_per_tick(
            1000.0, 10.0, 0) == 10.0
        assert (costing.expected_replay_ticks(2)
                < costing.expected_replay_ticks(10))


# -----------------------------------------------------------------------------
# The launcher
# -----------------------------------------------------------------------------

LAUNCH = ["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
          "--requests", "3", "--max-tokens", "4", "--slots", "2",
          "--paged", "--page-size", "4"]


def _req_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("req ")]


def test_launcher_survives_process_kill(tmpdir, capsys):
    """``--fault-kind process_kill`` with ``--checkpoint-dir``: the killed
    engine is replaced by a restored one, the run prints the warm restart
    and the ``durability:`` line, and its streams are those of a run
    without the fault; ``--resume`` on that directory restores it."""
    from repro_torch.launch import serve as launch
    launch.main(LAUNCH)
    want = _req_lines(capsys.readouterr().out)
    d = os.path.join(str(tmpdir), "ckpt")
    durable = LAUNCH + ["--checkpoint-dir", d, "--checkpoint-interval", "2",
                        "--fault-kind", "process_kill", "--fault-tick", "3"]
    launch.main(durable)
    out = capsys.readouterr().out
    assert "warm-restarting from " + d in out
    assert "durability: " in out and "replayed 1 ticks on restore" in out
    assert _req_lines(out) == want
    # the drained run restored: every stream again, the kill not again
    launch.main(durable + ["--resume", "--requests", "0"])
    out = capsys.readouterr().out
    assert _req_lines(out) == want and "durability: " in out
    assert "warm-restarting" not in out


@pytest.mark.parametrize("bad, message", [
    (["--checkpoint-interval", "-1"], "--checkpoint-interval must be >= 0"),
    (["--checkpoint-interval", "2"],
     "--checkpoint-interval requires --checkpoint-dir"),
    (["--resume"], "--resume requires --checkpoint-dir"),
    (["--fault-kind", "process_kill"],
     "--fault-kind process_kill requires --checkpoint-dir"),
    (["--compact-threshold", "1.5"], "--compact-threshold must be in"),
    (["--prefill-chunk", "6"], "must be a multiple of --page-size")])
def test_launcher_rejects_bad_durability_flags(bad, message, capsys):
    from repro_torch.launch import serve as launch
    with pytest.raises(SystemExit):
        launch.main(LAUNCH + bad)
    assert message in capsys.readouterr().err
