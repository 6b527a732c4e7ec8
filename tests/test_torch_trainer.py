"""The port's checkpointing Trainer (``repro_torch.train.loop.Trainer``)
and its CheckpointManager against the JAX package, on the CPU.

* mirrors of ``tests/test_train.py`` (convergence, exact-stream restart,
  synchronous checkpoint on preemption) and ``tests/test_checkpoint.py``
  (round trip, latest step, async save, shape mismatch, keep-k, stale tmp
  dirs, crash atomicity, dtype cast; its sharding test has no counterpart
  on one card);
* the port's Trainer against JAX's Trainer on bridged tiny weights: the
  same losses and params after 4 steps, at ``test_torch_train.py``'s fp32
  bound (2e-5; the port's flash route through K6-K8's plain versions
  against JAX's sdpa route);
* checkpoints cross between the two managers in both directions, with
  equal arrays and verified checksums, and a resume after a crossing
  trains on as the writer's own run does;
* a resume equals a straight run bit for bit; a save snapshots the
  tensors before it returns (the port updates them in place); bf16 leaves
  round-trip as raw words and hash as the reference hashes an
  ``ml_dtypes`` bf16 array; a flipped byte is refused;
* the launcher's ``--engine loop --ckpt-dir --resume`` on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JCkptConfig
from repro.checkpoint import CheckpointManager as JCkptManager
from repro.checkpoint import manager as j_manager
from repro.data import DataConfig as JDataConfig
from repro.data import make_pipeline as j_make_pipeline
from repro.models import transformer as jtf
from repro.optim import AdamWConfig as JAdamW
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch import bridge
from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                    tree_checksum)
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.launch import train as t_launch
from repro_torch.models import transformer as ttf
from repro_torch.models.common import flatten
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer


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


TOL = dict(rtol=2e-5, atol=2e-5)
VOCAB = 64


def _jcfg():
    """tests/test_train.py::_tiny's config."""
    return jtf.LMConfig(name="t", d_model=48, n_heads=4, n_kv_heads=4,
                        d_ff=96, vocab=VOCAB, pattern=(jtf.BlockSpec(),),
                        repeats=2, remat="none", vocab_pad_multiple=1)


def _models(seed=0):
    """JAX params and the port's bridged copy (with the port's config)."""
    jcfg = _jcfg()
    params = jtf.init_lm(jax.random.PRNGKey(seed), jcfg,
                         dtype=jnp.float32).params
    tcfg = bridge.config_from_dict(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def _data(**kw):
    base = dict(vocab=VOCAB, seq_len=16, global_batch=4, source="markov")
    base.update(kw)
    return base


def _ttrainer(tcfg, tparams, ckpt_dir=None, steps=6, **kw):
    return Trainer(loss_fn=lambda p, b: ttf.loss_fn(p, tcfg, b),
                   params=tparams, opt_cfg=AdamWConfig(lr=1e-3),
                   train_cfg=TrainConfig(num_steps=steps, log_every=1, **kw),
                   pipeline=make_pipeline(DataConfig(**_data())),
                   ckpt_cfg=(CheckpointConfig(str(ckpt_dir))
                             if ckpt_dir else None))


def _jtrainer(jcfg, params, ckpt_dir=None, steps=6):
    return JTrainer(loss_fn=lambda p, b: jtf.loss_fn(p, jcfg, b),
                    params=params, opt_cfg=JAdamW(lr=1e-3),
                    train_cfg=JTrainConfig(num_steps=steps, log_every=1),
                    pipeline=j_make_pipeline(JDataConfig(**_data())),
                    ckpt_cfg=(JCkptConfig(str(ckpt_dir)) if ckpt_dir
                              else None))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _assert_trees(got, want, exact=False, path=""):
    got, want = _np_tree(got), _np_tree(want)
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_trees(got[k], want[k], exact, f"{path}/{k}")
    elif exact:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)


# -- tests/test_train.py mirrors ------------------------------------------------

def test_loss_decreases_on_markov():
    _, _, tcfg, tparams = _models()
    tr = Trainer(loss_fn=lambda p, b: ttf.loss_fn(p, tcfg, b),
                 params=tparams, opt_cfg=AdamWConfig(lr=3e-3),
                 train_cfg=TrainConfig(num_steps=50, log_every=10),
                 pipeline=make_pipeline(DataConfig(**_data(
                     seq_len=32, global_batch=8))))
    tr.run()
    losses = [e["loss"] for e in tr.metrics_log]
    assert losses[-1] < losses[0] - 0.3, losses


def test_restart_resumes_exact_stream(tmp_path):
    """Kill after N steps, restart from another seed: same data position
    and step count, restored from the checkpoint."""
    _, _, tcfg, tparams = _models(seed=3)
    tr = _ttrainer(tcfg, tparams, tmp_path, checkpoint_every=3)
    tr.run(3)
    tr.save(wait=True)
    tr2 = _ttrainer(tcfg, _models(seed=99)[3], tmp_path)
    assert tr2.maybe_restore()
    assert tr2.step_num == 3
    assert tr2.pipeline.state == {"step": 3}
    assert int(tr2.opt_state["step"]) == 3
    assert all(p.requires_grad for p in flatten(tr2.params)[0])


def test_preemption_checkpoints_synchronously(tmp_path):
    _, _, tcfg, tparams = _models(seed=4)
    tr = _ttrainer(tcfg, tparams, tmp_path, steps=100, checkpoint_every=1000)
    orig = tr._step_fn

    def step_then_preempt(*a):
        out = orig(*a)
        tr._preempted = True
        return out
    tr._step_fn = step_then_preempt
    tr.run()
    assert tr.ckpt.latest_step() == tr.step_num == 1


def test_resume_equals_straight_run(tmp_path):
    """3 steps, save, a fresh Trainer from another seed restores and runs
    3 more: params and optimizer state equal a straight 6-step run's, bit
    for bit (the CPU is deterministic)."""
    _, _, tcfg, tparams = _models(seed=5)
    straight = _ttrainer(tcfg, tparams)
    straight.run(6)
    first = _ttrainer(tcfg, _models(seed=5)[3], tmp_path)
    first.run(3)
    first.save(wait=True)
    resumed = _ttrainer(tcfg, _models(seed=6)[3], tmp_path)
    assert resumed.maybe_restore()
    resumed.run(3)
    assert resumed.step_num == straight.step_num == 6
    _assert_trees(resumed.params, straight.params, exact=True)
    _assert_trees(resumed.opt_state, straight.opt_state, exact=True)
    assert [e["loss"] for e in resumed.metrics_log] == \
        [e["loss"] for e in straight.metrics_log][3:]


def test_trainer_matches_jax_trainer():
    """4 steps on the same bridged weights and Markov stream: every step's
    loss, and the final params and optimizer state."""
    jcfg, params, tcfg, tparams = _models(seed=1)
    jtr = _jtrainer(jcfg, params)
    ttr = _ttrainer(tcfg, tparams)
    jtr.run(4)
    ttr.run(4)
    np.testing.assert_allclose([e["loss"] for e in ttr.metrics_log],
                               [e["loss"] for e in jtr.metrics_log], **TOL)
    np.testing.assert_allclose([e["grad_norm"] for e in ttr.metrics_log],
                               [e["grad_norm"] for e in jtr.metrics_log],
                               **TOL)
    _assert_trees(ttr.params, jtr.params)
    _assert_trees(ttr.opt_state, jtr.opt_state)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_frameworks(tmp_path, writer):
    """A Trainer's checkpoint written by one framework restores into the
    other's Trainer (fresh weights from another seed): equal arrays, the
    step and the stream state, through the reader's integrity gate; both
    then train 2 more steps alike."""
    jcfg, params, tcfg, tparams = _models(seed=2)
    if writer == "jax":
        src = _jtrainer(jcfg, params, tmp_path)
        dst = _ttrainer(tcfg, _models(seed=7)[3], tmp_path)
    else:
        src = _ttrainer(tcfg, tparams, tmp_path)
        dst = _jtrainer(jcfg, _models(seed=7)[1], tmp_path)
    src.run(2)
    src.save(wait=True)
    manifest = json.loads((tmp_path / "ckpt_00000002" /
                           "manifest.json").read_text())
    assert dst.maybe_restore()
    assert dst.step_num == 2 and dst.pipeline.state == {"step": 2}
    _assert_trees(dst.params, src.params, exact=True)
    _assert_trees(dst.opt_state, src.opt_state, exact=True)
    with np.load(tmp_path / "ckpt_00000002" / "arrays.npz") as z:
        named = [(n, z[n]) for n in manifest["names"]]
    assert tree_checksum(named, manifest["extra"]) == \
        j_manager.tree_checksum(named, manifest["extra"]) == \
        manifest["checksum"]
    src.run(2)
    dst.run(2)
    _assert_trees(dst.params, src.params)


def test_launcher_loop_ckpt_resume(tmp_path):
    """``python -m repro_torch.launch.train --arch starcoder2-7b --smoke
    --device cpu --steps 4 --ckpt-dir D`` (the loop engine by default)
    checkpoints; ``--resume`` restores step 4 and trains to step 8."""
    ckpt = tmp_path / "ckpt"
    rep1, rep2 = tmp_path / "r1.json", tmp_path / "r2.json"
    t_launch.main(["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
                   "--steps", "4", "--ckpt-dir", str(ckpt), "--report",
                   str(rep1)])
    first = json.loads(rep1.read_text())
    assert first["step"] == 4 and np.isfinite(first["metrics"]["loss"])
    assert "summary" not in first              # the loop engine's report
    assert CheckpointManager(CheckpointConfig(str(ckpt))).latest_step() == 4
    t_launch.main(["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
                   "--engine", "loop", "--steps", "4", "--ckpt-dir",
                   str(ckpt), "--resume", "--report", str(rep2)])
    second = json.loads(rep2.read_text())
    assert second["step"] == 8
    assert CheckpointManager(CheckpointConfig(str(ckpt))).latest_step() == 8


def test_smoke_trainer_heartbeat(tmp_path):
    """``build_smoke_trainer`` with a heartbeat directory beats each step."""
    tr = t_launch.build_smoke_trainer("starcoder2-7b", steps=2,
                                      ckpt_dir=None, device="cpu",
                                      heartbeat_dir=str(tmp_path))
    tr.run()
    beat = json.loads((tmp_path / "host0.json").read_text())
    assert beat["step"] == 2 and beat["host_id"] == "host0"


# -- tests/test_checkpoint.py mirrors -------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.arange(4, dtype=torch.float32)},
            "opt": {"m": torch.zeros((8, 4)),
                    "step": torch.tensor(3, dtype=torch.int32)}}


def _mgr(tmp_path, **kw):
    return CheckpointManager(CheckpointConfig(str(tmp_path), **kw))


def test_save_restore(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    tree = _tree()
    mgr.save(10, tree, extra={"data_state": {"step": 10}})
    step, restored, extra = mgr.restore(target=tree)
    assert step == 10 and extra["data_state"]["step"] == 10
    assert mgr.peek_extra() == {"data_state": {"step": 10}}
    _assert_trees(restored, tree, exact=True)
    names = json.loads((tmp_path / "ckpt_00000010" /
                        "manifest.json").read_text())["names"]
    assert names == ["opt/m", "opt/step", "params/b", "params/w"]


def test_latest_selected(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    for s in (1, 5, 3):
        mgr.save(s, _tree(s))
    assert mgr.latest_step() == 5


def test_async_save_then_wait(tmp_path):
    mgr = _mgr(tmp_path, async_save=True)
    mgr.save(1, _tree())
    mgr.wait()
    assert mgr.latest_step() == 1


def test_async_save_snapshots_before_return(tmp_path):
    """The tensors change in place right after ``save`` returns, before
    the writer thread is joined: the checkpoint holds the values at the
    call."""
    mgr = _mgr(tmp_path, async_save=True)
    tree = _tree(4)
    want = {k: {n: t.clone() for n, t in v.items()} for k, v in tree.items()}
    mgr.save(2, tree)
    for t in flatten(tree)[0]:
        t.add_(1)
    mgr.wait()
    _, restored, _ = mgr.restore(target=tree)
    _assert_trees(restored, want, exact=True)


def test_shape_mismatch_rejected(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    mgr.save(1, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros((9, 4))
    with pytest.raises(ValueError):
        mgr.restore(target=bad)
    missing = _tree()
    missing["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError):
        mgr.restore(target=missing)
    with pytest.raises(ValueError):
        mgr.restore()


def test_keep_last_k(tmp_path):
    mgr = _mgr(tmp_path, keep_last=2, async_save=False)
    for s in range(5):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_stale_tmp_cleaned(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    stale = tmp_path / "ckpt_00000001.tmp.abc"
    stale.mkdir()
    mgr.save(2, _tree())
    assert not stale.exists()


def test_crash_leaves_no_partial_checkpoint(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    mgr.save(7, _tree())
    partial = tmp_path / "ckpt_00000009.tmp.x"
    partial.mkdir()
    (partial / "arrays.npz").write_bytes(b"garbage")
    assert mgr.all_steps() == [7]
    assert mgr.latest_step() == 7


def test_dtype_cast_on_restore(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    mgr.save(1, {"w": torch.ones(4)})
    _, restored, _ = mgr.restore(target={"w": torch.empty(4,
                                                          dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], torch.ones(4, dtype=torch.bfloat16))


def test_bf16_leaves_as_raw_words(tmp_path):
    """A bf16 leaf is stored as its 16-bit words with ``bfloat16`` in the
    manifest, restores bit for bit, and hashes as the reference's
    ``tree_checksum`` hashes the same values as an ``ml_dtypes`` bf16
    array."""
    w = torch.randn((5, 3), generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    mgr = _mgr(tmp_path, async_save=False)
    mgr.save(1, {"w": w, "s": torch.tensor(2, dtype=torch.int32)})
    manifest = json.loads((tmp_path / "ckpt_00000001" /
                           "manifest.json").read_text())
    assert manifest["dtypes"] == {"s": "int32", "w": "bfloat16"}
    _, restored, _ = mgr.restore(target={"w": w, "s": torch.tensor(0)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], w)
    assert restored["s"].dtype == torch.int64 and int(restored["s"]) == 2
    jw = np.asarray(jnp.asarray(w.float().numpy(), jnp.bfloat16))
    want = j_manager.tree_checksum(
        [("s", np.asarray(2, np.int32)), ("w", jw)], {})
    assert manifest["checksum"] == want


def test_flipped_byte_refused(tmp_path):
    """One flipped bit in an array, rewritten into a well-formed npz (so
    only the manifest checksum can catch it), makes restore raise."""
    mgr = _mgr(tmp_path, async_save=False)
    tree = _tree()
    mgr.save(1, tree)
    path = tmp_path / "ckpt_00000001" / "arrays.npz"
    with np.load(path) as z:
        arrays = {n: z[n].copy() for n in z.files}
    arrays["params/w"].view(np.uint8)[5] ^= 0x01
    os.remove(path)
    np.savez(path, **arrays)
    with pytest.raises(RuntimeError, match="integrity"):
        mgr.restore(target=tree)
