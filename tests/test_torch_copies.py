"""Modules the port keeps as copies (it imports nothing of ``repro``) must
behave as their originals: the scheduler and the page pool state for
state, the sustainability engine, the int8 quantizer's constants, the
speculative drafters' names, the speculative cost model, the training
token pipeline, the fleet fault-tolerance module (heartbeats, health
monitor, elastic planner), the sustainability advisor, the CNN configs,
the host half of the fault injector, the pool auditor's ownership
reconciliation and the durability tier's journal, request records, EWMA
lists, config fingerprint and costing helpers value for value. The only difference allowed is
the port's extra ``h100_sxm`` device.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import advisor as j_advisor
from repro.core import energy as j_energy
from repro.data import pipeline as j_pipeline
from repro.core import grid as j_grid
from repro.core import hw as j_hw
from repro.core import lca as j_lca
from repro.core import roofline as j_rl
from repro.core import sustain as j_sustain
from repro.models import cnn as j_cnn
from repro.models import costing as j_costing
from repro.quant import int8 as j_int8
from repro.serve import engine as j_engine
from repro.serve import faults as j_faults
from repro.serve import pages as j_pages
from repro.serve import scheduler as j_sched
from repro.serve import snapshot as j_snapshot
from repro.serve import spec as j_spec
from repro.train import ft as j_ft
from repro_torch.core import advisor as t_advisor
from repro_torch.core import energy as t_energy
from repro_torch.data import pipeline as t_pipeline
from repro_torch.core import grid as t_grid
from repro_torch.core import hw as t_hw
from repro_torch.core import lca as t_lca
from repro_torch.core import roofline as t_rl
from repro_torch.core import sustain as t_sustain
from repro_torch.models import cnn as t_cnn
from repro_torch.models import costing as t_costing
from repro_torch.quant import int8 as t_int8
from repro_torch.serve import engine as t_engine
from repro_torch.serve import faults as t_faults
from repro_torch.serve import pages as t_pages
from repro_torch.serve import scheduler as t_sched
from repro_torch.serve import snapshot as t_snapshot
from repro_torch.serve import spec as t_spec
from repro_torch.train import ft as t_ft


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


POLICIES = [("fifo", 0), ("longest_prompt", 0), ("longest_prompt", 3)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy,age", POLICIES)
def test_scheduler_state_for_state(policy, age, seed):
    """A random sequence of submit / select (with and without a capacity
    gate) / requeue / drop / load leaves both queues in the same order and
    selects the same requests at every step."""
    rng = np.random.default_rng(seed)
    scheds = [m.Scheduler(m.SchedulerConfig(policy=policy,
                                            age_boost_ticks=age))
              for m in (j_sched, t_sched)]
    reqs = ({}, {})
    uid = 0
    for tick in range(120):
        op = rng.integers(0, 6)
        if op <= 1:
            uid += 1
            n = int(rng.integers(1, 20))
            for s, m, book in zip(scheds, (j_engine, t_engine), reqs):
                book[uid] = m.Request(uid, np.arange(n), submit_tick=tick)
                s.submit(book[uid])
        elif op == 2:
            n_free = int(rng.integers(0, 4))
            cut = int(rng.integers(0, 20))
            fits = (lambda r: len(r.prompt) <= cut) if rng.random() < 0.5 \
                else None
            picked = [[r.uid for r in s.select(n_free, fits=fits, now=tick)]
                      for s in scheds]
            assert picked[0] == picked[1]
            if picked[0] and rng.random() < 0.5:
                for s, book in zip(scheds, reqs):
                    s.requeue_front([book[u] for u in picked[0]])
        elif op == 3:
            mod = int(rng.integers(2, 5))
            dropped = [[r.uid for r in s.drop(lambda r: r.uid % mod == 0)]
                       for s in scheds]
            assert dropped[0] == dropped[1]
        elif op == 4 and rng.random() < 0.2:
            for s in scheds:
                s.load(list(reversed(s.pending)))
        assert [r.uid for r in scheds[0].pending] == \
            [r.uid for r in scheds[1].pending]
        assert len(scheds[0]) == len(scheds[1])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", ["lru", "cost"])
def test_page_pool_state_for_state(policy, seed):
    """A random sequence of alloc, alloc_run, publish, lookup (kept, or
    rolled back with unbook_lookup as a deferral does), release and the
    evictions that allocation under pressure forces: both pools return the
    same pages and end every step in the same state, with a clean audit.
    Blocks come from a two-token alphabet, so lookups hit."""
    rng = np.random.default_rng(seed)

    def cost(depth):
        return float((3 * depth) % 4 + depth)

    pools = [m.PagePool(12, 4, evict_policy=policy, block_cost=cost)
             for m in (j_pages, t_pages)]
    held = []                       # page runs both pools hand out alike

    def block():
        return tuple(int(t) for t in rng.integers(0, 2, 4))

    def both(fn):
        out = [fn(p) for p in pools]
        assert out[0] == out[1]
        return out[0]

    for _ in range(400):
        op = int(rng.integers(0, 7))
        n = int(rng.integers(1, 5))
        if op <= 1:
            run = both(lambda p: p.alloc(n) if op == 0 else p.alloc_run(n))
            if run:
                held.append(run)
        elif op == 2 and held:
            run = held[int(rng.integers(0, len(held)))]
            blocks = [block() for _ in run]

            def publish(p):
                parent = j_pages.ROOT
                for page, blk in zip(run, blocks):
                    parent = p.publish(page, parent, blk)
                return parent

            both(publish)
        elif op in (3, 4):
            blocks = [block() for _ in range(n)]
            hits = both(lambda p: p.lookup(blocks))
            if op == 4:             # a deferred admission rolls back
                for p in pools:
                    p.release_all(hits)
                    p.unbook_lookup(len(hits), len(blocks))
            elif hits:
                held.append(hits)
        elif op >= 5 and held:
            run = held.pop(int(rng.integers(0, len(held))))
            for p in pools:
                p.release_all(run)
        assert pools[0].state_dict() == pools[1].state_dict()
        assert pools[0].audit() == pools[1].audit() == []
    assert pools[1].stats.evicted_blocks > 0
    assert pools[1].stats.hit_blocks > 0
    assert t_pages.block_tokens([1, 2, 3, 4, 5], 2) == \
        j_pages.block_tokens([1, 2, 3, 4, 5], 2)
    assert t_pages.fragmentation([3, 4, 9, 1]) == \
        j_pages.fragmentation([3, 4, 9, 1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reconcile_ownership_equal(seed):
    """Random slot page lists over a pool in which pages were allocated,
    forked and released (a page listed twice by a slot, a page the pool
    freed, a page shared by more slots than hold it) and random spike
    holds: both packages' ``reconcile_ownership``, each over its own pool
    in the same state, return the same violations."""
    rng = np.random.default_rng(seed)
    pools = [m.PagePool(16, 4) for m in (j_pages, t_pages)]
    held = [p.alloc(10) for p in pools][0]
    assert all(p.fork(held[:3]) == held[:3] for p in pools)
    for p in pools:
        p.release_all(held[8:])
    found = 0
    for _ in range(40):
        pages = list(range(16))
        slots = [[int(x) for x in rng.choice(pages, int(rng.integers(0, 5)))]
                 for _ in range(3)]
        holds = [(int(rng.integers(0, 9)),
                  [int(x) for x in rng.choice(pages, int(rng.integers(0,
                                                                      3)))])
                 for _ in range(int(rng.integers(0, 3)))]
        got = [m.reconcile_ownership(p, slots, holds)
               for m, p in zip((j_snapshot, t_snapshot), pools)]
        assert got[0] == got[1]
        found += len(got[1])
    assert found > 0
    assert t_snapshot.reconcile_ownership(pools[1], [held[:8]], []) == []


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fault_injector_host_half_equal(seed):
    """A random plan over every kind (several events a tick, victims in and
    out of the active set): for every tick both injectors give the same
    stall seconds, the same poison vector (NaN, +inf or None), the same
    filtered readback on the first attempt and a retry, and the same
    ledger."""
    rng = np.random.default_rng(seed)
    events = [(int(rng.integers(0, 12)), str(rng.choice(j_faults.FAULT_KINDS)),
               int(rng.integers(-1, 4)), float(rng.integers(1, 4)),
               int(rng.integers(1, 3))) for _ in range(24)]
    injectors = [m.FaultInjector(m.FaultPlan(seed=seed, events=tuple(
        m.FaultEvent(*e) for e in events))) for m in (j_faults, t_faults)]
    assert injectors[0].plan.max_tick == injectors[1].plan.max_tick
    for tick in range(13):
        active = sorted(int(x) for x in rng.choice(4, int(rng.integers(0, 4)),
                                                   replace=False))
        arr = rng.integers(0, 2, (3, 4)).astype(np.int32)
        out = [(inj.stall_seconds(tick), inj.logit_poison(tick, active, 4),
                [inj.filter_readback(arr, tick, a) for a in (0, 1)],
                dict(inj.counts), inj.faults_injected)
               for inj in injectors]
        assert out[0][0] == out[1][0]
        if out[0][1] is None:
            assert out[1][1] is None
        else:
            np.testing.assert_array_equal(out[0][1], out[1][1])
        for a, b in zip(out[0][2], out[1][2]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert out[0][3:] == out[1][3:]
    assert sum(injectors[1].counts.values()) > 0


def _journal_ops(rng):
    """A random sequence of journal appends: submits of random prompts,
    budgets, temperatures, deadlines and fan-outs, ticks of random
    finishes (with and without n-best streams)."""
    ops = []
    for i in range(30):
        if rng.integers(0, 2):
            ops.append(("submit", dict(
                uid=i, prompt=[int(t) for t in rng.integers(0, 99, 5)],
                max_tokens=int(rng.integers(1, 9)),
                temperature=[None, 0.0, 0.7][int(rng.integers(0, 3))],
                deadline_ticks=[None, 3][int(rng.integers(0, 2))],
                n_best=int(rng.integers(1, 3)), tick=i)))
        else:
            fin = [[int(u), [int(t) for t in rng.integers(0, 99, 3)],
                    None if rng.integers(0, 2) else [[1, 2], [3]]]
                   for u in rng.integers(0, 30, int(rng.integers(0, 3)))]
            ops.append(("tick", dict(tick=i, finished=fin)))
    return ops


@pytest.mark.parametrize("seed", [0, 1])
def test_journal_equal(seed, tmp_path):
    """The same appends give the same bytes, lengths and ``seq`` in both
    packages' ``Journal``; a torn tail is truncated the same way on open,
    and both read the same records back."""
    ops = _journal_ops(np.random.default_rng(seed))
    paths, lens = [], []
    for name, m in (("j", j_snapshot), ("t", t_snapshot)):
        path = str(tmp_path / f"{name}.jsonl")
        j = m.Journal(path)
        out = []
        for kind, kw in ops:
            fn = j.append_submit if kind == "submit" else j.append_tick
            out.append(fn(**kw))
        out.append((j.seq, j.bytes_written))
        j.close()
        with open(path, "a") as f:
            f.write('{"kind": "tick", "tick": 99, "fini')     # torn write
        paths.append(path)
        lens.append(out)
    assert lens[0] == lens[1]
    reopened = [m.Journal(p) for m, p in zip((j_snapshot, t_snapshot),
                                             paths)]
    assert [(j.seq, j.bytes_written) for j in reopened] == [lens[0][-1]] * 2
    assert reopened[0].records() == reopened[1].records()
    for j in reopened:
        j.close()
    with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
        assert f0.read() == f1.read()


def test_request_dict_round_trip_equal():
    """``request_to_dict`` of the same request is the same dict in both
    packages, and ``request_from_dict`` rebuilds it in each."""
    dicts = []
    for eng, snap in ((j_engine, j_snapshot), (t_engine, t_snapshot)):
        req = eng.Request(7, np.arange(6, dtype=np.int32), max_tokens=5,
                          temperature=0.5, deadline_ticks=4, submit_tick=2,
                          n_best=2, fork_group=3, fork_idx=1)
        req.generated = [4, 5]
        req.nbest = [[4, 5], [6]]
        d = snap.request_to_dict(req)
        back = snap.request_from_dict(json.loads(json.dumps(d)))
        assert snap.request_to_dict(back) == d
        assert isinstance(back, eng.Request)
        dicts.append(d)
    assert dicts[0] == dicts[1]


def test_ewma_lists_equal():
    lists = []
    for ft, snap in ((j_ft, j_snapshot), (t_ft, t_snapshot)):
        e = ft.Ewma(alpha=0.5)
        assert snap._ewma_to_list(e) == [None, 0]
        for x in (1.0, 3.0, 2.5):
            e.update(x)
        v = snap._ewma_to_list(e)
        back = snap._ewma_from_list(json.loads(json.dumps(v)), 0.5)
        assert (back.value, back.n, back.alpha) == (e.value, e.n, 0.5)
        lists.append(v)
    assert lists[0] == lists[1]


def test_check_fingerprint_messages_equal():
    """The fingerprint's fields and the refusal message naming a field are
    the same in both packages."""
    import jax.numpy as jnp
    import torch
    assert t_snapshot._FINGERPRINT_FIELDS == j_snapshot._FINGERPRINT_FIELDS
    j_cfg = j_engine.ServeConfig(paged=True, page_size=4,
                                 cache_dtype=jnp.bfloat16)
    t_cfg = t_engine.ServeConfig(paged=True, page_size=4,
                                 cache_dtype=torch.bfloat16, device="cpu")
    fps = [m.config_fingerprint(c) for m, c in ((j_snapshot, j_cfg),
                                                (t_snapshot, t_cfg))]
    assert fps[0] == fps[1] and fps[1]["cache_dtype"] == "bfloat16"
    for field, value in (("page_size", 8), ("cache_dtype", "float32"),
                         ("spec_k", 2)):
        msgs = []
        for m, c, fp in ((j_snapshot, j_cfg, fps[0]),
                         (t_snapshot, t_cfg, fps[1])):
            with pytest.raises(RuntimeError) as err:
                m.check_fingerprint(c, {**fp, field: value})
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1] and field in msgs[1]


@pytest.mark.parametrize("interval", [-1, 0, 1, 2, 5, 32])
def test_durability_costing_equal(interval):
    assert (t_costing.expected_replay_ticks(interval)
            == j_costing.expected_replay_ticks(interval))
    for snap_bytes, journal in ((0.0, 0.0), (2.15e9, 410.0), (1e3, 10.0)):
        assert (t_costing.durability_overhead_bytes_per_tick(
            snap_bytes, journal, interval)
            == j_costing.durability_overhead_bytes_per_tick(
                snap_bytes, journal, interval))


def test_scheduler_rejects_unknown_policy():
    for m in (j_sched, t_sched):
        with pytest.raises(ValueError):
            m.Scheduler(m.SchedulerConfig(policy="random"))


def test_devices_equal_plus_h100():
    assert set(t_hw.DEVICES) == set(j_hw.DEVICES) | {"h100_sxm"}
    for name, spec in j_hw.DEVICES.items():
        assert dataclasses.asdict(t_hw.DEVICES[name]) == \
            dataclasses.asdict(spec), name
    h100 = t_hw.DEVICES["h100_sxm"]
    assert h100.peak_flops == 989e12 and h100.hbm_bw == 3.35e12
    assert h100.lca_study == "bardon2020" and "estimate" in h100.notes


@pytest.mark.parametrize("name", sorted(j_hw.DEVICES))
def test_lca_values_equal(name):
    js, ts = j_hw.DEVICES[name], t_hw.DEVICES[name]
    assert t_lca.dies_per_wafer(ts) == j_lca.dies_per_wafer(js)
    assert t_lca.embodied_energy_mj(ts, per_module=True) == \
        j_lca.embodied_energy_mj(js, per_module=True)
    for mix in ("AZ", "CA", "TX", "NY"):
        assert t_lca.embodied_carbon_g(ts, mix) == \
            j_lca.embodied_carbon_g(js, mix)


def test_lca_tables_equal():
    assert t_lca.table2() == j_lca.table2()
    assert t_lca.tpu_package_embodied_mj() == j_lca.tpu_package_embodied_mj()
    assert t_grid.all_mix_intensities() == j_grid.all_mix_intensities()


@pytest.mark.parametrize("bench,phase", [("alexnet", "inference_ternary"),
                                         ("alexnet", "train_fp32"),
                                         ("vgg16", "train_fp32")])
def test_energy_tables_equal(bench, phase):
    assert t_energy.table3_efficiency(bench, phase) == \
        j_energy.table3_efficiency(bench, phase)


def test_energy_models_equal():
    for n in (0.0, 1.5e9, 7.3e12):
        assert t_energy.dram_energy_j(n) == j_energy.dram_energy_j(n)
        for name in j_hw.DEVICES:
            assert t_energy.compute_energy_j(n, t_hw.DEVICES[name]) == \
                j_energy.compute_energy_j(n, j_hw.DEVICES[name])
    kw = dict(flops_per_device=3e14, bytes_per_device=2e11,
              collective_bytes_per_device=1e9, n_devices=4)
    jt, tt = j_rl.RooflineTerms(**kw), t_rl.RooflineTerms(**kw)
    assert dataclasses.asdict(t_energy.step_energy(tt)) == \
        dataclasses.asdict(j_energy.step_energy(jt))
    assert t_energy.carbon_per_1k_steps(tt, "NY") == \
        j_energy.carbon_per_1k_steps(jt, "NY")
    assert t_energy.tokens_per_joule(tt, 4096.0) == \
        j_energy.tokens_per_joule(jt, 4096.0)


def test_sustain_equal():
    assert t_sustain.breakeven_time_s(3.2e6, 20.0, 5.0) == \
        j_sustain.breakeven_time_s(3.2e6, 20.0, 5.0)
    assert t_sustain.indifference_time_s(4e6, 1e6, 10.0, 3.0) == \
        j_sustain.indifference_time_s(4e6, 1e6, 10.0, 3.0)


@pytest.mark.parametrize("name", ["SERVING_QUANT_KEYS", "_OUT_DIMS",
                                  "SCALE_FLOOR"])
def test_int8_constants_equal(name):
    """One copy of each in the port (costing imports the quantizer's)."""
    assert getattr(t_int8, name) == getattr(j_int8, name)
    assert t_costing.SERVING_QUANT_KEYS is t_int8.SERVING_QUANT_KEYS
    for key in j_int8.SERVING_QUANT_KEYS:
        assert t_int8.weight_out_dims(key) == j_int8.weight_out_dims(key)


def test_spec_drafters_equal():
    assert t_spec.DRAFTERS == j_spec.DRAFTERS


# (matmul_elems, n_attn, attn_dims, ctx_sum, n_active, width or k)
SPEC_COST_ARGS = [(1.5e6, 2, 48, 0.0, 1, 1), (6.9e9, 32, 4608, 5123.0, 8, 5),
                  (2.3e4, 3, 64, 97.0, 3, 3)]


@pytest.mark.parametrize("fn", ["spec_verify_flops",
                                "spec_oracle_draft_flops"])
@pytest.mark.parametrize("args", SPEC_COST_ARGS)
def test_spec_costing_equal(fn, args):
    assert getattr(t_costing, fn)(*args) == getattr(j_costing, fn)(*args)


@pytest.mark.parametrize("source", ["synthetic", "markov"])
def test_pipeline_batches_equal(source):
    """``batch_at`` gives the original's tokens and labels at every step,
    for a whole batch and for each rank's slice after ``reshard``, and the
    step state moves the same way."""
    kw = dict(vocab=97, seq_len=12, global_batch=4, seed=3, source=source)
    pipes = [m.make_pipeline(m.DataConfig(**kw))
             for m in (j_pipeline, t_pipeline)]
    for step in (0, 1, 7, 1000):
        want, got = (p.batch_at(step) for p in pipes)
        assert set(got) == set(want) == {"tokens", "labels"}
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    for p in pipes:
        next(p)
        next(p)
    assert pipes[0].state == pipes[1].state == {"step": 2}
    for rank in range(2):
        shards = [p.reshard(rank, 2) for p in pipes]
        assert shards[0].state == shards[1].state == {"step": 2}
        for step in (0, 5):
            want, got = (sh.batch_at(step) for sh in shards)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])


# -- train/ft.py: tests/test_ft.py's cases through both modules -----------------

def _beat(m, directory, host, step, ewma, t):
    w = m.HeartbeatWriter(directory, host)
    w._step_time = ewma           # bypass EWMA warmup for test determinism
    w.beat(step, ewma, now=t)


def _monitor_case(m, d, case):
    """One of tests/test_ft.py's TestMonitor cases through module ``m`` in
    directory ``d``: the list of assess() results it produces."""
    os.makedirs(d)
    if case == "all_healthy":
        for h in ("h0", "h1", "h2"):
            _beat(m, d, h, 10, 1.0, t=1000.0)
        return [m.HealthMonitor(d).assess(now=1001.0)]
    if case == "dead_host":
        _beat(m, d, "h0", 10, 1.0, t=1000.0)
        _beat(m, d, "h1", 10, 1.0, t=900.0)
        return [m.HealthMonitor(d, m.MonitorConfig(dead_after_s=60))
                .assess(now=1000.0)]
    if case == "straggler_strikes":
        mon = m.HealthMonitor(d, m.MonitorConfig(straggler_factor=2.0,
                                                 strikes_to_exclude=3))
        for h, t in (("h0", 1.0), ("h1", 1.0), ("h2", 5.0)):
            _beat(m, d, h, 10, t, t=1000.0)
        return [mon.assess(now=1000.0) for _ in range(3)]
    if case == "recovered_straggler":
        mon = m.HealthMonitor(d, m.MonitorConfig(straggler_factor=2.0,
                                                 strikes_to_exclude=2))
        for h, t in (("h0", 1.0), ("h1", 1.0), ("h2", 5.0)):
            _beat(m, d, h, 10, t, t=1000.0)
        out = [mon.assess(now=1000.0)]
        _beat(m, d, "h2", 11, 1.0, t=1000.5)
        out.append(mon.assess(now=1001.0))
        _beat(m, d, "h2", 12, 5.0, t=1001.5)
        out.append(mon.assess(now=1002.0))
        return out
    assert case == "torn_heartbeat"
    _beat(m, d, "h0", 3, 1.0, t=1000.0)
    with open(os.path.join(d, "h1.json"), "w") as f:
        f.write("{not json")
    return [m.HealthMonitor(d).assess(now=1000.5)]


MONITOR_CASES = {
    "all_healthy": [(["h0", "h1", "h2"], [], [])],
    "dead_host": [(["h0"], ["h1"], [])],
    "straggler_strikes": [(["h0", "h1", "h2"], [], [])] * 2
    + [(["h0", "h1"], [], ["h2"])],
    "recovered_straggler": [(["h0", "h1", "h2"], [], [])] * 3,
    "torn_heartbeat": [(["h0"], [], [])],
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_ft_monitor_equal(case, tmp_path):
    got = _monitor_case(t_ft, str(tmp_path / "t"), case)
    want = _monitor_case(j_ft, str(tmp_path / "j"), case)
    assert [tuple(map(list, r)) for r in got] == \
        [tuple(map(list, r)) for r in want] == MONITOR_CASES[case]
    beat = {}
    for m, sub in ((j_ft, "j"), (t_ft, "t")):
        with open(tmp_path / sub / "h0.json") as f:
            beat[sub] = json.load(f)
    assert beat["j"] == beat["t"]


# (chips_per_host, model_parallel, healthy hosts, current plan's hosts)
PLANNER_CASES = [(4, 16, 128, None), (4, 16, 50, None), (4, 16, 64, 64),
                 (4, 16, 64, 50), (2, 8, 5, None)]


@pytest.mark.parametrize("cph,mp,hosts,current", PLANNER_CASES)
def test_ft_planner_equal(cph, mp, hosts, current):
    plans = []
    for m in (j_ft, t_ft):
        pl = m.ElasticPlanner(chips_per_host=cph, model_parallel=mp)
        cur = pl.plan(current) if current else None
        plans.append(dataclasses.asdict(pl.plan(hosts, current=cur)))
    assert plans[0] == plans[1]


def test_ft_planner_infeasible_and_ewma_equal():
    for m in (j_ft, t_ft):
        with pytest.raises(RuntimeError):
            m.ElasticPlanner(chips_per_host=1, model_parallel=16).plan(8)
    ewmas = [m.Ewma(alpha=0.8) for m in (j_ft, t_ft)]
    for x in (3.0, 1.0, 7.5, 2.0):
        assert ewmas[0].update(x) == ewmas[1].update(x)
    assert dataclasses.asdict(ewmas[0]) == dataclasses.asdict(ewmas[1])


# (platforms, activity, service years, reference throughput's platform):
# tests/test_sustain.py::test_fpga_never_selected and
# tests/test_system.py::test_advisor_closes_the_loop's inputs
ADVISOR_CASES = [(("gpu", "rm_pim", "fpga"), 0.7, 5, "rm_pim"),
                 (("gpu", "rm_pim"), 0.9, 3, "rm_pim"),
                 (("gpu", "rm_pim"), 0.2, 3, "rm_pim"),
                 (("gpu", "rm_pim", "fpga"), 0.3, 5, "rm_pim")]


@pytest.mark.parametrize("names,activity,years,ref", ADVISOR_CASES)
def test_advisor_equal(names, activity, years, ref):
    """``recommend`` gives the same winner, dominated set, totals,
    indifference times and narrative."""
    recs = []
    for adv, sus in ((j_advisor, j_sustain), (t_advisor, t_sustain)):
        plats = [sus.platform_from_hw(n, "alexnet", "train_fp32")
                 for n in names]
        by = {p.name: p for p in plats}
        recs.append(dataclasses.asdict(adv.recommend(
            plats, sus.Duty(activity), years * sus.SECONDS_PER_YEAR,
            ref_throughput=by[ref].throughput)))
    assert recs[0] == recs[1]
    if activity == 0.7:
        assert "fpga" in recs[1]["dominated"] and recs[1]["winner"] != "fpga"
    if activity in (0.9, 0.2):
        assert recs[1]["winner"] == ("gpu" if activity == 0.9 else "rm_pim")


def test_advisor_fleet_equal():
    """``fleet_recommend`` on the same roofline terms."""
    opts = [(8, 1e15, 2e12, 1e10, 4096.0), (64, 1e15, 2e12, 5e10, 4096.0)]
    out = []
    for adv, rl in ((j_advisor, j_rl), (t_advisor, t_rl)):
        out.append(adv.fleet_recommend(
            [adv.MeshOption(f"m{n}", rl.RooflineTerms(f, b, c, n), tok)
             for n, f, b, c, tok in opts], "NY", service_years=3.0,
            activity=0.5))
    assert out[0] == out[1]


@pytest.mark.parametrize("name", ["ALEXNET", "VGG16"])
def test_cnn_configs_equal(name):
    assert dataclasses.asdict(getattr(t_cnn, name)) == \
        dataclasses.asdict(getattr(j_cnn, name))


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
def test_shape_grid_equal(shape_name):
    """The port's ``SHAPES`` and each arch's ``shapes`` hold the
    reference's, value for value."""
    from repro.configs import base as j_cfgbase
    from repro_torch.configs import base as t_cfgbase
    assert list(t_cfgbase.SHAPES) == list(j_cfgbase.SHAPES)
    assert dataclasses.asdict(t_cfgbase.SHAPES[shape_name]) == \
        dataclasses.asdict(j_cfgbase.SHAPES[shape_name])
    assert t_cfgbase.all_arch_ids(lm_only=True) == \
        j_cfgbase.all_arch_ids(lm_only=True)
    for arch_id in j_cfgbase.all_arch_ids():
        assert t_cfgbase.get(arch_id).shapes == j_cfgbase.get(arch_id).shapes


@pytest.mark.parametrize("table", ["DEFAULT_RULES", "LONG_CONTEXT_RULES"])
def test_sharding_rules_equal(table):
    """The port's rule tables equal ``repro.parallel.sharding``'s, entry
    for entry and in order."""
    from repro.parallel import sharding as j_sh
    from repro_torch.parallel import sharding as t_sh
    assert list(getattr(t_sh, table).items()) == \
        list(getattr(j_sh, table).items())
