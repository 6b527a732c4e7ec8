"""The port's examples and benchmarks (``repro_torch.examples``,
``repro_torch.benchmarks``) run on the CPU, and the CUDA wrappers of K9,
K10 and K11 refuse CPU tensors instead of computing on them.

On the CPU the kernels' plain versions stand in for them, so the benches'
parity numbers here check the plumbing (the same route, exact update
parity), not the kernels; chip_smoke.py runs the same benches on the card.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import kernel_bench, train_bench
from repro_torch.examples import (edge_cnn_repro, quickstart, serve_lm,
                                  sustainability_report, train_e2e)
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import int8_matmul as t_im
from repro_torch.kernels import ternary_matmul as t_tm


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


def test_train_bench_cpu(tmp_path):
    """Both arms run their steps, the fused engine reads back once per
    tick, its update equals ``make_train_step``'s bit for bit, and the
    gradient parities are at fp32 rounding."""
    out = tmp_path / "bench.json"
    res = train_bench.bench(out=out, device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["workload"]["device"] == "cpu"
    assert res["update_parity_max_abs_diff"] == 0.0
    g = res["grad_parity_vs_ref"]
    assert g["flash_attention_max_abs_err"] < 1e-4
    assert g["int8_matmul_max_abs_err"] < 1e-4
    assert g["int8_matmul_dscale_rel_err"] < 1e-5
    assert res["fused"]["ticks"] == train_bench.STEPS // train_bench.STEPS_PER_TICK
    assert res["fused"]["host_readbacks_per_step"] == \
        1 / train_bench.STEPS_PER_TICK
    assert res["fused"]["energy"]["bwd_fwd_ratio"] == 2.0
    assert np.isfinite(res["reference"]["final_loss"])


def test_kernel_bench_cpu(tmp_path, capsys):
    rows = kernel_bench.run("cpu")
    assert [r[0] for r in rows] == ["kernel/ternary_matmul_oracle",
                                    "kernel/ternary_matmul",
                                    "kernel/ternary_matmul_vs_oracle",
                                    "kernel/flash_attention_oracle",
                                    "kernel/flash_attention",
                                    "kernel/flash_attention_vs_oracle"]
    assert rows[2][2].startswith("max_err=0.00e+00;ref_max=")
    assert rows[0][2] == "shape=256x2048x512;flops=5.37e+08"
    assert rows[-1][2] == "max_err=0.00e+00"
    kernel_bench.main(["--device", "cpu", "--out", str(tmp_path / "k.json")])
    assert len(json.loads((tmp_path / "k.json").read_text())) == 6
    out = capsys.readouterr().out
    assert "kernel/flash_attention_vs_oracle" in out
    assert "kernel/ternary_matmul_vs_oracle" in out


def test_train_e2e_cpu_scale_resumes(tmp_path, capsys):
    """``python -m repro_torch.examples.train_e2e --device cpu --cpu-scale``
    trains, checkpoints, and a second run resumes from the latest step."""
    args = ["--device", "cpu", "--cpu-scale", "--steps", "4", "--batch",
            "2", "--seq", "32", "--ckpt-dir", str(tmp_path)]
    train_e2e.main(args)
    first = capsys.readouterr().out
    assert "fresh start" in first and "latest step 4" in first
    train_e2e.main(args)
    second = capsys.readouterr().out
    assert "resumed from step 4" in second and "latest step 8" in second


def test_model_100m_config():
    """The e2e model: 12 layers, d_model 768, 12/4 heads of 64, vocab
    32768, five 256-token-window layers per global one."""
    cfg = train_e2e.model_100m()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.vocab) == (12, 768, 12, 4, 64, 32768)
    assert [s.window for s in cfg.pattern] == [256] * 5 + [-1]


def test_quickstart_cpu(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step  100" in out and "-> [" in out


def test_serve_lm_cpu(capsys):
    """``python -m repro_torch.examples.serve_lm --device cpu``: gemma3-27b's
    smoke config (its sliding-window layers) by default, every request
    served, billed as h100_sxm with the wall-time figures left out."""
    serve_lm.main(["--device", "cpu", "--requests", "5",
                   "--max-tokens", "4"])
    out = capsys.readouterr().out
    assert "serving 5 requests on gemma3-27b (smoke config)" in out
    assert "... 5 requests completed" in out
    assert out.count("prompt toks -> 4 generated") == 5
    assert "billed as h100_sxm" in out and "left out" in out
    assert "J/token (live)" not in out


def test_edge_cnn_repro_cpu(capsys):
    """``python -m repro_torch.examples.edge_cnn_repro --device cpu``: the
    ternary route (K11's plain version here) agrees with the dequantized
    forward, and the Table 3, Fig. 2 and advisor sections print."""
    res = edge_cnn_repro.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert res["route_max_abs_diff"] < 1e-5
    assert "ternary route (K11) vs dequantized forward: max |diff|" in out
    assert "Table 3 (inference, ternary PIM):" in out
    assert "Fig 2a break-even" in out
    assert "GPU beats RM above activity ratio 40%" in out
    assert "activity  30%: winner=rm_pim" in out
    assert "activity  90%: winner=gpu (dominated: ['fpga'])" in out


def test_sustainability_report_cpu(capsys):
    sustainability_report.main([])
    out = capsys.readouterr().out
    for head in ("Table 1", "Table 2", "Table 3", "Figure 2"):
        assert head in out
    assert "2b/2c: GPU beats RM (vgg16)" in out
    assert "ROADMAP item 13" in out


def test_cuda_wrappers_refuse_cpu_tensors():
    """K9's, K10's and K11's wrappers take CUDA tensors only: a CPU tensor
    raises before anything is built or launched."""
    dy = torch.zeros((4, 16))
    q = torch.zeros((32, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        t_im.int8_matmul_dx(dy, q, torch.ones(16), torch.float32)
    qq = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        t_fa.flash_attention(qq, qq[:, :, :1], qq[:, :, :1], scale=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        t_tm.ternary_matmul(dy, q, torch.ones(16))
    assert t_im.int8_matmul_dx.launches == 0
    assert t_fa.flash_attention.launches == 0
    assert t_tm.ternary_matmul.launches == 0
