"""Modules the port keeps as copies (it imports nothing of ``repro``) must
behave as their originals: the scheduler state for state, and the
sustainability engine value for value. The only difference allowed is
the port's extra ``h100_sxm`` device.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import energy as j_energy
from repro.core import grid as j_grid
from repro.core import hw as j_hw
from repro.core import lca as j_lca
from repro.core import roofline as j_rl
from repro.core import sustain as j_sustain
from repro.serve import engine as j_engine
from repro.serve import scheduler as j_sched
from repro_torch.core import energy as t_energy
from repro_torch.core import grid as t_grid
from repro_torch.core import hw as t_hw
from repro_torch.core import lca as t_lca
from repro_torch.core import roofline as t_rl
from repro_torch.core import sustain as t_sustain
from repro_torch.serve import engine as t_engine
from repro_torch.serve import scheduler as t_sched

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
