"""K1, the serve path's decode attention: the port's public wrapper
(repro_torch.kernels.ops.decode_attention) on CPU tensors against the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs.

On the CPU the port runs the kernel's plain PyTorch version
(``kernels/ref.py``); the CUDA kernel itself is held against that plain
version on the card by chip_smoke.py. The bound is 1e-5 in fp32, as
tests/test_serve_core.py holds the Pallas kernel to masked sdpa, and dead
slots (length 0) must give exact zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ops
from repro_torch.kernels import decode_attention as k1


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


HKV = 2


def _inputs(rep, d, sk, seed=0):
    rng = np.random.default_rng(seed)
    b = 5
    q = rng.standard_normal((b, HKV * rep, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, HKV, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, HKV, d)).astype(np.float32)
    # ragged: a dead slot, a single key, the full cache and two in between
    lens = np.array([0, 1, sk, sk // 2 + 3, 7], np.int32)
    return q, k, v, lens


def _jax(q, k, v, lens, scale, window):
    return np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        scale=scale, window=window, interpret=True))


@pytest.mark.parametrize("window", [-1, 6])
@pytest.mark.parametrize("d,sk", [(16, 37), (128, 200)])
@pytest.mark.parametrize("rep", [1, 2, 9])
def test_matches_pallas_kernel(rep, d, sk, window):
    q, k, v, lens = _inputs(rep, d, sk)
    scale = d ** -0.5
    got = ops.decode_attention(*map(torch.from_numpy, (q, k, v, lens)),
                               scale=scale, window=window).numpy()
    want = _jax(q, k, v, lens, scale, window)
    live = lens > 0
    assert np.abs(got[live] - want[live]).max() < 1e-5
    assert (got[~live] == 0.0).all() and (want[~live] == 0.0).all()


def test_bf16_inputs_keep_q_dtype():
    """bf16 q and K/V: output in q's dtype, within bf16 output rounding
    (2e-2 absolute) of the Pallas kernel on the same bf16 values."""
    q, k, v, lens = _inputs(9, 128, 200, seed=1)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.decode_attention(qb, kb, vb, torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    want = _jax(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (qb, kb, vb)), lens, 128 ** -0.5, -1)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)
    assert (got[0] == 0).all()


def test_cpu_path_does_not_touch_the_kernel():
    q, k, v, lens = _inputs(2, 16, 37)
    before = k1.decode_attention.launches
    ops.decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    assert k1.decode_attention.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back: a CPU tensor is an error."""
    q, k, v, lens = map(torch.from_numpy, _inputs(2, 16, 37))
    with pytest.raises(ValueError, match="CUDA"):
        k1.decode_attention(q, k, v, lens, scale=0.25)


class _NoKernelDevice(torch.Tensor):
    """A CPU tensor that reports a device the port has no kernel for."""

    @property
    def device(self):
        return torch.device("xpu")


def test_no_kernel_for_other_devices():
    """A device with no kernel raises. Meta tensors (the dry-run's shapes)
    launch no kernel and compute nothing: the entry gives an empty meta
    output of the kernel's shape and dtype, and bills the kernel's cost to
    an active counter."""
    from repro_torch.core import flops
    other = torch.zeros((2, 4, 16)).as_subclass(_NoKernelDevice)
    kv = torch.zeros((2, 8, 2, 16))
    with pytest.raises(ValueError, match="no kernel"):
        ops.decode_attention(other, kv, kv, torch.ones(2, dtype=torch.int32))
    q = torch.empty((2, 4, 16), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 8, 2, 16), dtype=torch.bfloat16, device="meta")
    with flops.count() as cost:
        out = ops.decode_attention(q, k, k, torch.empty(2, device="meta"))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    # every slot at its capacity of 8 keys: 4 H D FLOPs a key
    assert cost.by_prim == {"decode_attention": 4.0 * 2 * 8 * 4 * 16}


def test_build_is_keyed_on_the_source():
    """The library path is a hash of the source and flags under build/;
    computing it compiles nothing."""
    path = build.library_path("decode_attention")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("decode_attention-")
    assert path.suffix == ".so"
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
