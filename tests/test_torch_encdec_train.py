"""The training launcher's smoke path for every family on the port
(``repro_torch.launch.train``), against the JAX launcher, on the CPU.

* the mirror of ``tests/test_system.py::test_smoke_trainer_builder_all_families``
  (mamba2, moonshot, whisper) and the launcher's ``main`` on whisper;
* the port's ``Trainer`` on bridged JAX whisper-smoke weights and zero
  audio frames: the JAX Trainer's losses and grad norms over 3 steps, at
  ``tests/test_torch_trainer.py``'s bound (2e-5; the
  port's decoder on the flash route through K6-K8's plain versions, JAX's
  on its masked ``sdpa``);
* the fused engine refuses an encoder-decoder arch, as the reference's
  does;
* qwen2-vl-smoke's launcher loss on one bridged batch equals the JAX
  launcher's, zero vision embeddings over its first ``vision_tokens``
  positions in both.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import train as j_launch
from repro_torch import bridge
from repro_torch.launch import train as t_launch

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The smoke models' ops are far below any parallel grain: one torch
    thread while this file runs, the worker's setting back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(params, tree):
    """The bridged arrays of ``tree`` into the port Trainer's params, key
    by key and in place (its optimizer state keeps pointing at them)."""
    assert set(params) == set(tree)
    for k, w in tree.items():
        if isinstance(w, dict):
            _load(params[k], w)
        else:
            with torch.no_grad():
                params[k].copy_(w)


def _bridged(arch, jparams):
    jcfg = j_base.get(arch).make_smoke()
    if j_base.get(arch).kind == "encdec":
        tcfg = bridge.encdec_config_from_dict(dataclasses.asdict(jcfg))
        return bridge.encdec_params_from_numpy(_np(jparams), tcfg,
                                               device="cpu")
    tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
    return bridge.params_from_numpy(_np(jparams), tcfg, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "moonshot-v1-16b-a3b",
                                  "whisper-large-v3"])
def test_smoke_trainer_builder_all_families(arch):
    """The launcher builds a runnable smoke trainer for every family: two
    steps, a finite loss."""
    tr = t_launch.build_smoke_trainer(arch, steps=2, ckpt_dir=None,
                                      global_batch=4, seq_len=16,
                                      device="cpu")
    m = tr.run()
    assert np.isfinite(m["loss"]) and tr.step_num == 2


def test_launcher_main_trains_encdec(capsys):
    """``python -m repro_torch.launch.train --arch whisper-large-v3 --smoke
    --steps 2 --device cpu``: the loop engine, a finite final loss."""
    t_launch.main(["--arch", "whisper-large-v3", "--smoke", "--steps", "2",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines()
                if x.startswith("final metrics:"))
    assert np.isfinite(float(line.split('"loss": ')[1].split(",")[0]))


def test_trainer_matches_jax_trainer_whisper():
    """3 steps of the smoke trainers on the same bridged whisper-smoke
    weights, zero frames and Markov stream: every step's loss and grad
    norm. (The params are not compared leaf by leaf: AdamW turns a
    near-zero gradient into a step of about the learning rate whose sign
    is rounding noise, and the key biases' gradients are zero in exact
    arithmetic; the losses carry the updates.)"""
    kw = dict(steps=3, ckpt_dir=None, global_batch=4, seq_len=16)
    jtr = j_launch.build_smoke_trainer("whisper-large-v3", **kw)
    ttr = t_launch.build_smoke_trainer("whisper-large-v3", device="cpu",
                                       **kw)
    _load(ttr.params, _bridged("whisper-large-v3", jtr.params))
    jtr.run()
    ttr.run()
    assert len(ttr.metrics_log) == len(jtr.metrics_log) == 3
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([e[key] for e in ttr.metrics_log],
                                   [e[key] for e in jtr.metrics_log], **TOL)


def test_fused_engine_refuses_encdec():
    """``--engine fused`` on an encoder-decoder arch exits with a pointer
    to the loop engine, as the reference's ``build_smoke_engine`` does."""
    with pytest.raises(SystemExit, match="--engine loop"):
        t_launch.build_smoke_engine("whisper-large-v3", steps=2,
                                    device="cpu")
    with pytest.raises(SystemExit, match="--engine loop"):
        t_launch.main(["--arch", "whisper-large-v3", "--smoke", "--engine",
                       "fused", "--device", "cpu"])


def test_qwen2_vl_launcher_loss_matches_jax():
    """The two launchers' qwen2-vl-smoke trainers on the same bridged
    weights and one batch: the same loss (zero vision embeddings over the
    first ``vision_tokens`` positions in both)."""
    kw = dict(steps=1, ckpt_dir=None, global_batch=4, seq_len=16)
    jtr = j_launch.build_smoke_trainer("qwen2-vl-72b", **kw)
    ttr = t_launch.build_smoke_trainer("qwen2-vl-72b", device="cpu", **kw)
    assert j_base.get("qwen2-vl-72b").make_smoke().vision_tokens > 0
    _load(ttr.params, _bridged("qwen2-vl-72b", jtr.params))
    batch = jtr.pipeline.batch_at(0)
    jloss, _ = jtr.loss_fn(jtr.params, {k: jax.numpy.asarray(v)
                                        for k, v in batch.items()})
    tloss, _ = ttr.loss_fn(ttr.params, {k: torch.from_numpy(np.array(v))
                                        for k, v in batch.items()})
    np.testing.assert_allclose(tloss.detach().item(), float(jloss), **TOL)
