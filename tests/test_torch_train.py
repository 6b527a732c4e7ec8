"""The port's training path (repro_torch.train, optim, transformer.loss_fn)
against the JAX package on the same weights, bridged array by array.

* ``loss_fn`` and its gradient tree: the port's ``positions=None`` route
  (the flash kernels' plain versions on the CPU) against JAX's
  ``flash_train=True`` (Pallas in interpret mode) and against its sdpa
  route, and the port's explicit-positions route (``sdpa``) against JAX's;
* ``apply_updates`` in every ``state_dtype``, with and without an fp32
  master, and the four schedules;
* a 2-tick, k = 3 ``TrainEngine`` run against the JAX engine with
  ``use_flash_vjp=True`` on the same params and Markov stream: per-step
  losses, final params, and each tick's ``TrainStepMetrics`` bill;
* one host readback per tick, ``lm_train_step_cost``, ``make_train_step``
  with gradient accumulation, and the launcher's CPU smoke run.

Tolerance: fp32 2e-5 (``tests/test_kernels_grad.py`` and
``test_train_engine.py``'s bound for the flash route's final params); the
cost model and the bills are equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accounting as j_acct
from repro.data import DataConfig as JDataConfig
from repro.data import make_pipeline as j_make_pipeline
from repro.models import costing as j_costing
from repro.models import transformer as jtf
from repro.optim import AdamWConfig as JAdamW
from repro.optim import apply_updates as j_apply
from repro.optim import init_opt_state as j_init
from repro.optim import schedules as j_sched
from repro.train import TrainEngine as JEngine
from repro.train import TrainEngineConfig as JEngineConfig
from repro.train import engine as j_engine
from repro.train import make_train_step as j_make_step
from repro_torch import bridge
from repro_torch.core import accounting as t_acct
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.launch import train as t_launch
from repro_torch.models import costing as t_costing
from repro_torch.models.common import flatten
from repro_torch.models import transformer as ttf
from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state
from repro_torch.optim import schedules as t_sched
from repro_torch.train import TrainEngine, TrainEngineConfig, make_train_step
from repro_torch.train import engine as t_engine


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


VOCAB, SEQ, BATCH = 64, 16, 4
TOL = dict(rtol=2e-5, atol=2e-5)


def _jcfg(**kw):
    """tests/test_train_engine.py::_cfg with GQA (4 query heads on 2 KV
    heads)."""
    base = dict(name="t", d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                vocab=VOCAB, pattern=(jtf.BlockSpec(),), repeats=2,
                remat="none", vocab_pad_multiple=1)
    base.update(kw)
    return jtf.LMConfig(**base)


def _models(jcfg, seed=0):
    params = jtf.init_lm(jax.random.PRNGKey(seed), jcfg,
                         dtype=jnp.float32).params
    tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, device="cpu")
    return params, tcfg, tparams


def _np(tree):
    """A tree of tensors or arrays as fp32 numpy; an int8 moment
    ``{"q", "s"}`` dequantized."""
    if isinstance(tree, dict) and set(tree) == {"q", "s"}:
        return _np(tree["q"]) * _np(tree["s"])
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree, np.float32)


def _close_trees(got, want, path="", **tol):
    """Every leaf of the port's tree against JAX's, as fp32 numpy. ``tol``
    may be a function of the wanted leaf."""
    got, want = _np(got), _np(want)
    if not isinstance(want, dict):
        kw = tol["of"](want) if "of" in tol else (tol or TOL)
        np.testing.assert_allclose(got, want, err_msg=path, **kw)
        return
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        _close_trees(got[k], want[k], f"{path}/{k}", **tol)


def _grads(tparams, tcfg, batch):
    leaves, rebuild = flatten(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = ttf.loss_fn(tparams, tcfg, batch)
    return loss, aux, rebuild(list(torch.autograd.grad(loss, leaves)))


# port route (positions given?), JAX flash_train, JAX positions given?,
# params dtype
ROUTES = {"flash-vs-jax-flash": (False, True, False, "float32"),
          "flash-vs-jax-sdpa": (False, False, False, "float32"),
          "positions-vs-jax-positions": (True, False, True, "float32"),
          "bf16-flash-vs-jax-flash": (False, True, False, "bfloat16")}
# bf16 params (starcoder2's smoke config as init_lm makes them: bf16
# weights, fp32 norm scales) through the flash route on both sides: the
# loss within 1e-2 relative and each gradient leaf within 6e-2 of its max
# (tests/test_torch_flash.py's bf16 bound: bf16 roundings of O(1) values,
# which the two frameworks make at other places)
BF16_LOSS_RTOL, BF16_LEAF = 1e-2, 6e-2


def _leaf_of_max(want):
    return dict(rtol=0, atol=BF16_LEAF * max(float(np.abs(want).max()),
                                             1e-30))


@pytest.mark.parametrize("route", list(ROUTES))
def test_loss_and_grads_match_jax(route, sc2_smoke):
    """``loss_fn`` with a loss mask, z-loss and logit softcap over a
    global and a windowed layer: the loss, its aux terms and every leaf of
    the gradient tree (the tied embedding gets both the gather's and the
    unembedding's share) equal JAX's on the same weights. In bf16, on the
    starcoder2 smoke config's bf16 params (the module's config): the
    port's flash route (K6-K8's plain versions) against ``jax.grad``
    through ``flash_attention_vjp`` in interpret mode, at the bf16
    tolerance above."""
    t_pos, j_flash, j_pos, dtype = ROUTES[route]
    if dtype == "float32":
        jcfg = _jcfg(pattern=(jtf.BlockSpec(), jtf.BlockSpec(window=5)),
                     repeats=1, z_loss=1e-3, logit_softcap=30.0)
        params, tcfg, tparams = _models(jcfg)
        assert tcfg.z_loss == 1e-3
        tol = {}
    else:
        jcfg, tcfg = sc2_smoke[0], sc2_smoke[2]
        params = jtf.init_lm(jax.random.PRNGKey(0), jcfg,
                             dtype=jnp.bfloat16).params
        tparams = bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        assert tparams["embed"]["w"].dtype == torch.bfloat16
        tol = {"of": _leaf_of_max}
    rng = np.random.default_rng(1)
    toks = rng.integers(0, VOCAB, (2, 13)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (2, 13)).astype(np.int32)
    mask = (rng.random((2, 13)) > 0.2).astype(np.float32)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "loss_mask": jnp.asarray(mask)}
    if j_pos:
        jbatch["positions"] = jnp.asarray(pos)
    jrun = dataclasses.replace(jcfg, flash_train=j_flash)
    (jloss, jaux), jgrads = jax.value_and_grad(jtf.loss_fn, has_aux=True)(
        params, jrun, jbatch)
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels),
              "loss_mask": torch.from_numpy(mask)}
    if t_pos:
        tbatch["positions"] = torch.from_numpy(pos.copy())
    loss, aux, grads = _grads(tparams, tcfg, tbatch)
    loss_tol = TOL if dtype == "float32" else dict(rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **loss_tol)
    np.testing.assert_allclose(float(aux["ce"].detach()), float(jaux["ce"]),
                               **loss_tol)
    assert float(aux["tokens"]) == float(jaux["tokens"])
    _close_trees(grads, jgrads, **tol)


def _opt_tree(rng, dtype):
    shapes = {"a": (4, 6), "b": {"c": (5,), "d": (3, 4, 2)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return np.array(jnp.asarray(rng.standard_normal(s), dtype),
                        np.float32)
    return make(shapes)


def _to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dtype)


OPT_CASES = {"fp32": ("fp32", "float32", True),
             "bf16-state": ("bf16", "float32", True),
             "int8-state": ("int8", "float32", True),
             "bf16-params-master": ("fp32", "bfloat16", True),
             "bf16-params-no-master": ("fp32", "bfloat16", False)}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_apply_updates_matches_jax(case):
    """Three AdamW steps (warmup-cosine lr, global-norm clipping on a
    gradient whose norm is above the clip) give JAX's params, moments,
    master, step, grad norm and lr; the port writes them in place."""
    mode, pdt, master = OPT_CASES[case]
    rng = np.random.default_rng(5)
    p0 = _opt_tree(rng, jnp.dtype(pdt))
    grads = [_opt_tree(rng, jnp.float32) for _ in range(3)]
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.1, grad_clip=1.0,
              state_dtype=mode, use_master=master)
    jcfg = JAdamW(lr=j_sched.warmup_cosine(1e-2, 2, 10), **kw)
    tcfg = AdamWConfig(lr=t_sched.warmup_cosine(1e-2, 2, 10), **kw)
    jp = jax.tree.map(lambda x: jnp.asarray(x, pdt), p0)
    js = j_init(jp, jcfg)
    tp = _to_torch(p0, getattr(torch, pdt))
    ts = init_opt_state(tp, tcfg)
    assert ("master" in ts) == ("master" in js)
    tp_id = id(tp["b"]["d"])
    for g in grads:
        jp, js, jm = j_apply(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, tm = apply_updates(tp, _to_torch(g, torch.float32), ts, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert id(tp["b"]["d"]) == tp_id and int(ts["step"]) == 3
    low = pdt == "bfloat16"
    # bf16 params and states: within one bf16 rounding; int8 moments:
    # within one code step of their scale (a rounding tie may flip a code)
    _close_trees(tp, jp, **(dict(rtol=8e-3, atol=1e-6) if low else TOL))
    tol = {"fp32": TOL, "bf16": dict(rtol=8e-3, atol=1e-9),
           "int8": dict(of=lambda w: dict(
               rtol=0, atol=1.01 * float(np.abs(w).max()) / 127.0))}[mode]
    for key in ("m", "v"):
        _close_trees(ts[key], js[key], key, **tol)
    if "master" in js:
        _close_trees(ts["master"], js["master"])


SCHEDULES = {"constant": (lambda m: m.constant(3e-3)),
             "warmup_cosine": (lambda m: m.warmup_cosine(1e-2, 4, 20, 1e-4)),
             "warmup_rsqrt": (lambda m: m.warmup_rsqrt(1e-2, 4)),
             "linear_decay": (lambda m: m.linear_decay(1e-2, 4, 20))}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    """Each schedule on a device step tensor equals JAX's, warmup and
    decay, including steps past the end."""
    jfn, tfn = SCHEDULES[name](j_sched), SCHEDULES[name](t_sched)
    for s in range(0, 26):
        got = tfn(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got),
                                   float(jfn(jnp.asarray(s, jnp.int32))),
                                   rtol=1e-6, atol=1e-12)


def _jpipe():
    return j_make_pipeline(JDataConfig(vocab=VOCAB, seq_len=SEQ,
                                       global_batch=BATCH, seed=0,
                                       source="markov"))


def _tpipe():
    return make_pipeline(DataConfig(vocab=VOCAB, seq_len=SEQ,
                                    global_batch=BATCH, seed=0,
                                    source="markov"))


def _acct(mod):
    return mod.CarbonAccountant(mod.AccountantConfig(device="tpu_v5e",
                                                     n_devices=1))


def test_engine_matches_jax_flash_engine():
    """Two ticks of k = 3 steps: the port's engine (flash route, plain
    versions on the CPU) against the JAX engine with ``use_flash_vjp``
    (Pallas in interpret mode) on the same params and Markov stream: every
    step's loss, grad norm and lr, the final params (2e-5, like
    test_train_engine.py:176), and every tick's bill, equal."""
    jcfg = _jcfg()
    params, tcfg, tparams = _models(jcfg)
    opt = dict(lr=2e-3)
    jacct, tacct = _acct(j_acct), _acct(t_acct)
    jeng = JEngine.for_lm(params, jcfg, opt_cfg=JAdamW(**opt),
                          pipeline=_jpipe(),
                          engine_cfg=JEngineConfig(steps_per_tick=3,
                                                   use_flash_vjp=True),
                          accountant=jacct)
    assert jeng.model_cfg.flash_train
    j_steps = []
    tick = jeng._tick

    def recording_tick(*args):
        out = tick(*args)
        j_steps.append(np.stack([np.asarray(out[2][k])
                                 for k in ("loss", "grad_norm", "lr")], 1))
        return out

    jeng._tick = recording_tick
    jeng.run(6)
    teng = TrainEngine.for_lm(tparams, tcfg, opt_cfg=AdamWConfig(**opt),
                              pipeline=_tpipe(),
                              engine_cfg=TrainEngineConfig(steps_per_tick=3),
                              accountant=tacct)
    teng.run(6)
    assert teng.params is tparams          # updated in place
    assert teng.host_readbacks == jeng.host_readbacks == 2
    np.testing.assert_allclose(np.concatenate(teng.step_log),
                               np.concatenate(j_steps), **TOL)
    _close_trees(teng.params, jeng.params)
    for tm, jm in zip(teng.metrics_log, jeng.metrics_log):
        for f in dataclasses.fields(jm):
            want, got = getattr(jm, f.name), getattr(tm, f.name)
            if f.name in t_engine.TRAIN_ACCOUNTING_EXEMPT:
                np.testing.assert_allclose(got, want, **TOL)
            elif f.name != "wall_s":
                assert got == want, f.name
    jt, tt = jacct.train_report(), tacct.train_report()
    assert tt == pytest.approx(jt, rel=1e-12)
    assert tt["bwd_fwd_ratio"] == 2.0


def test_engine_one_readback_per_tick():
    """run(7) at k = 3 is three ticks (3, 3, 1): three readbacks of the
    (k, 3) metrics block, the step counter and the stream's state follow,
    and the accountant bills seven steps."""
    _, tcfg, tparams = _models(_jcfg(repeats=1))
    acct = _acct(t_acct)
    eng = TrainEngine.for_lm(tparams, tcfg, opt_cfg=AdamWConfig(lr=1e-3),
                             pipeline=_tpipe(),
                             engine_cfg=TrainEngineConfig(steps_per_tick=3),
                             accountant=acct)
    last = eng.run(7)
    assert eng.host_readbacks == 3
    assert [b.shape for b in eng.step_log] == [(3, 3), (3, 3), (1, 3)]
    assert eng.step_num == 7 and eng.pipeline.state == {"step": 7}
    assert last["step"] == 7.0 and np.isfinite(last["loss"])
    assert acct.train_report()["steps"] == 7
    s = eng.summary()
    assert s["ticks"] == 3 and s["steps"] == 7
    assert s["tokens"] == 7 * BATCH * SEQ
    assert set(dataclasses.asdict(eng.metrics_log[0])) == set(
        f.name for f in dataclasses.fields(j_engine.TrainStepMetrics))
    assert t_engine.TRAIN_ACCOUNTING_EXEMPT == \
        j_engine.TRAIN_ACCOUNTING_EXEMPT


@pytest.fixture(scope="module")
def sc2_smoke():
    from repro.configs import starcoder2_7b as j_sc2
    jcfg = j_sc2.make_smoke()
    return (jcfg,) + _models(jcfg)


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_lm_train_step_cost_matches_jax(state_dtype, sc2_smoke):
    """The per-step cost model on the bridged starcoder2 smoke config and
    its optimizer state equals JAX's, field for field."""
    jcfg, params, tcfg, tparams = sc2_smoke
    jstate = j_init(params, JAdamW(state_dtype=state_dtype))
    tstate = init_opt_state(tparams, AdamWConfig(state_dtype=state_dtype))
    want = j_costing.lm_train_step_cost(params, jcfg, batch=3, seq_len=40,
                                        opt_state=jstate)
    got = t_costing.lm_train_step_cost(tparams, tcfg, batch=3, seq_len=40,
                                       opt_state=tstate)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_make_train_step_grad_accum_matches_jax():
    """One host-loop step with grad_accum = 2 (microbatch gradients summed
    in fp32 and averaged): the port's flash route against JAX's sdpa step,
    loss, grad norm and params."""
    jcfg = _jcfg(repeats=1)
    params, tcfg, tparams = _models(jcfg)
    batch = _jpipe().batch_at(0)
    opt = dict(lr=3e-3)
    jstep = j_make_step(lambda p, b: jtf.loss_fn(p, jcfg, b), JAdamW(**opt),
                        grad_accum=2)
    jp, _, jm = jstep(params, j_init(params, JAdamW(**opt)),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    for p in flatten(tparams)[0]:
        p.requires_grad_(True)
    tstep = make_train_step(lambda p, b: ttf.loss_fn(p, tcfg, b),
                            AdamWConfig(**opt), grad_accum=2)
    tp, ts, tm = tstep(tparams, init_opt_state(tparams, AdamWConfig(**opt)),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL)
    _close_trees(tp, jp)
    assert int(ts["step"]) == 1


def test_launcher_cpu_smoke(tmp_path):
    """``python -m repro_torch.launch.train --arch starcoder2-7b --smoke
    --device cpu --engine fused --steps 4 --steps-per-tick 2``: two ticks,
    finite losses, a report whose train block splits the phases with the
    backward at twice the forward; without ``--engine`` the launcher runs
    the reference's default, the host-loop Trainer."""
    report = tmp_path / "report.json"
    t_launch.main(["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
                   "--engine", "fused", "--steps", "4", "--steps-per-tick",
                   "2", "--report", str(report)])
    rep = json.loads(report.read_text())
    assert rep["summary"]["ticks"] == 2 and rep["summary"]["steps"] == 4
    assert np.isfinite(rep["metrics"]["loss"])
    train = rep["carbon"]["train"]
    assert train["steps"] == 4 and train["bwd_fwd_ratio"] == 2.0
    assert min(train["fwd_j"], train["bwd_j"], train["opt_j"]) > 0
    loop_report = tmp_path / "loop.json"
    t_launch.main(["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
                   "--steps", "2", "--report", str(loop_report)])
    loop = json.loads(loop_report.read_text())
    assert loop["step"] == 2 and "summary" not in loop
    assert np.isfinite(loop["metrics"]["loss"])
