"""The port's serve path (repro_torch.serve) against the JAX package's on the
same bridged fp32 weights, on the CPU.

Greedy streams must be identical to the JAX ``ServeEngine`` and to the
port's host-loop ``ReferenceEngine``; the modeled accounting must equal
JAX's to 1e-9 relative. Sampling at temperature > 0 cannot reproduce
JAX's threefry bits; it is held to determinism, slot independence and the
softmax distribution instead.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import starcoder2_7b as j_sc2
from repro.core import accounting as j_acct
from repro.models import transformer as jtf
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.core import accounting as t_acct
from repro_torch.serve import (ReferenceEngine, Scheduler, SchedulerConfig,
                               ServeConfig, ServeEngine)
from repro_torch.serve import engine as t_engine


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
    """tests/test_serve_core.py::_cfg."""
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


def _prompts(vocab, lens=(5, 9, 3, 12, 7, 1), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lens]


def _engine(name, **kw):
    _, _, tcfg, tparams = _models(name)
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 32)
    return ServeEngine(tparams, tcfg, ServeConfig(device="cpu", **kw))


def _drain(eng, prompts, max_tokens=6, **kw):
    for p in prompts:
        eng.submit(p, max_tokens=max_tokens, **kw)
    return {r.uid: r.generated for r in eng.run_until_drained()}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_greedy_streams_match_jax_engine_and_reference(name):
    """Mixed prompt lengths, a queue three times deeper than the slots."""
    jcfg, params, tcfg, tparams = _models(name)
    prompts = _prompts(jcfg.vocab)
    got = _drain(_engine(name), prompts)
    want = _drain(JServeEngine(params, jcfg,
                               JServeConfig(max_slots=2, max_len=32)),
                  prompts)
    ref = _drain(ReferenceEngine(tparams, tcfg,
                                 ServeConfig(max_slots=2, max_len=32,
                                             device="cpu")), prompts)
    assert got == want == ref
    assert all(len(s) == 6 for s in got.values())


def test_one_host_readback_per_tick():
    eng = _engine("serve-core")
    eng.submit(np.arange(4), max_tokens=8)
    eng.step()                              # admission + first tick
    base = eng.host_readbacks
    for i in range(4):                      # no admission, no finish
        assert eng.step() == []
        assert eng.host_readbacks == base + i + 1
    eng.run_until_drained()


def test_max_tokens_one_finishes_at_admission():
    eng = _engine("serve-core")
    _, _, tcfg, tparams = _models("serve-core")
    ref = ReferenceEngine(tparams, tcfg,
                          ServeConfig(max_slots=2, max_len=32, device="cpu"))
    for e in (eng, ref):
        e.submit(np.arange(5), max_tokens=1)
    done = eng.step()
    assert len(done) == 1 and len(done[0].generated) == 1
    assert eng.last_metrics.tokens == 0     # no decode tick ran for it
    assert done[0].generated == ref.run_until_drained()[0].generated


@pytest.mark.parametrize("at_prefill", [False, True])
def test_eos_stops_generation(at_prefill):
    """EOS is a token whose first occurrence in the free-running stream is
    known, so the stop point is exact."""
    prompt = np.arange(5) + 3
    free = _drain(_engine("starcoder2-smoke", max_slots=1), [prompt],
                  max_tokens=12)[1]
    if at_prefill:
        j = 0
    else:
        j = next(i for i in range(1, len(free)) if free[i] not in free[:i])
    got = _drain(_engine("starcoder2-smoke", max_slots=1, eos_id=free[j]),
                 [prompt], max_tokens=12)[1]
    assert got == free[:j + 1]


def _report(acct):
    # wall-time-derived keys differ between runs by nature
    wall = {"active_s", "operational_j", "operational_gco2",
            "amortized_fraction", "tokens_per_j", "j_per_token",
            "gco2_per_mtoken"}
    return {k: v for k, v in acct.report().items() if k not in wall}


def test_modeled_accounting_equals_jax():
    jcfg, params, tcfg, tparams = _models("starcoder2-smoke")
    prompts = _prompts(jcfg.vocab, lens=(5, 9, 3, 12, 7))
    ja = j_acct.CarbonAccountant(j_acct.AccountantConfig(
        device="tpu_v5e", n_devices=1, grid_mix="NY"))
    ta = t_acct.CarbonAccountant(t_acct.AccountantConfig(
        device="tpu_v5e", n_devices=1, grid_mix="NY"))
    je = JServeEngine(params, jcfg, JServeConfig(max_slots=2, max_len=32),
                      accountant=ja)
    te = ServeEngine(tparams, tcfg,
                     ServeConfig(max_slots=2, max_len=32, device="cpu"),
                     accountant=ta)
    assert _drain(te, prompts) == _drain(je, prompts)
    want, got = _report(ja), _report(ta)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=1e-9, abs=0.0), k
        else:
            assert got[k] == w, k
    assert got["bytes_moved"] > 0 and got["modeled_j_per_token"] > 0


def _sampled(max_slots, seed, policy="fifo"):
    _, _, tcfg, tparams = _models("serve-core")
    eng = ServeEngine(tparams, tcfg,
                      ServeConfig(max_slots=max_slots, max_len=32, seed=seed,
                                  device="cpu"),
                      scheduler=Scheduler(SchedulerConfig(policy=policy)))
    prompts = _prompts(61, lens=(4, 9, 6, 2))
    for i, p in enumerate(prompts):
        eng.submit(p, max_tokens=6, temperature=0.5 + 0.3 * i)
    return {r.uid: r.generated for r in eng.run_until_drained()}


def test_sampling_deterministic_and_slot_independent():
    a = _sampled(2, seed=0)
    assert a == _sampled(2, seed=0)
    # other slots, other batch company: the draws are keyed on
    # (seed, uid, token index), never on the slot
    assert a == _sampled(3, seed=0, policy="longest_prompt")
    assert a == _sampled(1, seed=0)
    assert a != _sampled(2, seed=1)


def test_sampler_draws_from_the_softmax():
    """Gumbel-max over the counter-based uniforms: over 40000 token
    indices the frequencies are the softmax at the temperature, within
    0.01 (about four standard errors)."""
    logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0]])
    temp = 0.7
    n = 40000
    idx = torch.arange(n)
    toks = t_engine._sample(logits.expand(n, -1), 3, torch.full((n,), 11),
                            idx, torch.full((n,), temp), sampled=True)
    freq = torch.bincount(toks, minlength=5).double() / n
    want = torch.softmax(logits[0].double() / temp, dim=0)
    assert (freq - want).abs().max() < 0.01


def test_greedy_slots_unaffected_by_sampled_neighbours():
    eng = _engine("serve-core", seed=0)
    pg = np.arange(5)
    eng.submit(pg, max_tokens=5, temperature=0.0)
    eng.submit(np.arange(4) + 8, max_tokens=5, temperature=0.9)
    got = {r.uid: r.generated for r in eng.run_until_drained()}
    alone = _drain(_engine("serve-core"), [pg], max_tokens=5)
    assert got[1] == alone[1]


def test_engine_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tcfg, tparams = _models("serve-core")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tparams, tcfg, ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReferenceEngine(tparams, tcfg, ServeConfig())


def test_summary_on_empty_engine_is_zero():
    s = _engine("serve-core").summary()
    assert s["ticks"] == 0 and s["decode_tokens_per_s"] == 0.0


def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    launch.main(["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
                 "--requests", "3", "--max-tokens", "2", "--slots", "2",
                 "--prompt-len", "5", "20", "--profile-ticks", "2"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "profile:" in out
    # CPU runs leave out the wall-time-derived report keys
    line = next(ln for ln in out.splitlines()
                if ln.startswith("carbon report (CPU run"))
    rep = json.loads(line[line.index("{"):])
    assert "j_per_token" not in rep and rep["modeled_j_per_token"] > 0
