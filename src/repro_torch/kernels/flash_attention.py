"""ctypes wrappers of the flash-attention CUDA kernels
(``csrc/flash_attention.cu``): the training forward with lse (K6), the dQ
backward (K7) and the dK/dV backward (K8), which replace the Pallas TPU
kernels behind ``repro.kernels.flash_attention.flash_attention_vjp``, and
the inference forward without lse (K10, with its int8-KV mode), which
replaces ``repro.kernels.flash_attention.flash_attention``.

Each wrapper checks device, dtypes, shapes and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports a CUDA error. Nothing is padded: the kernels
mask by length. ``<wrapper>.launches`` counts each kernel's launches.

Every kernel runs on the tensor cores (``route``), one kernel for each
dtype of q and head dim. fp32 q runs the 3xTF32 kernels, every product on
wgmma in hi/lo tf32 halves of each operand, fp32-accurate: K6 and K10 over
fp32 K/V or int8 codes, after a pre-pass in the same call that splits K
and V once into their planes in a workspace (``fwd_workspace``); K7 and
K8, whose register-only operands at head dim 168 stay plain fp32 planes
split as they are read (hi/lo planes of every operand do not fit a block's
shared memory at 192 columns). bf16 q runs the bf16 kernels (bf16 wgmma;
the products of two bf16 operands, S and dP, exact; the fp32 P and dS in
three exact bf16 planes against the bf16 tiles): K6 and K10 over bf16 K/V
or int8 codes widened exactly to bf16, one launch a call with no
workspace, and K7 and K8.
``<wrapper>.launches_by_kernel`` counts each kernel's launches by the name
``route`` gives it. K8 launches its blocks in ``dkv_block_order``: one a
(key tile, batch, KV head), walking the group's heads, or, where those
would leave SMs idle (``dkv_split``), one a head of the group, whose
partials the group's last block sums in head order in the same launch
(a workspace and counters from ``paged_decode_attention.scratch``).

Head dims 64 and 128; 8, 16 and 24 (the reference's smoke configs), which
run the D = 64 kernels; 112 (kimi-k2's and zamba2's), which runs the D =
128 kernels; and 168 (gemma3-27b's), whose kernels hold 192 columns
(``kernel_dim``; S and dP read 168 or 176 of them). Each reads and writes
the tensors' rows at their own width with zeros past it in shared memory
and in the fp32 forward's workspace planes, so the tensors are never
padded.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import DTYPES, check_cuda
from repro_torch.kernels.int8_matmul import _sm_count
from repro_torch.kernels.paged_decode_attention import scratch

_HEAD_DIMS = (8, 16, 24, 64, 112, 128, 168)
# K8's keys a block (kDkvKeys in the source)
DKV_KEYS = 64
# the fp32 forward's key tile and the hi/lo planes a tile takes in its
# workspace (kFwdKeys, kFwdPlanes in the source)
FWD_KEYS, FWD_PLANES = 32, 4


def kernel_dim(d: int) -> int:
    """The columns the kernels' tiles hold for tensors of head dim ``d``:
    ``d`` rounded up to a multiple of 64 (their tiles zero past ``d``):
    64 for the dims under it, 128 for 112, 192 for 168."""
    return -(-d // 64) * 64


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that q of ``dtype`` at head dim ``d`` runs: "tensor_cores"
    for the forward (K6, K10) and the backward (K7, K8) in every mode and
    at every head dim the kernels take; raises for any other dtype or head
    dim."""
    if d not in _HEAD_DIMS or dtype not in DTYPES:
        raise ValueError(f"flash attention: no kernel for {dtype} at "
                         f"head_dim {d} (takes fp32 or bf16 at {_HEAD_DIMS})")
    return "tensor_cores"


def dkv_split(units: int, rep: int, sms: int) -> bool:
    """Whether K8 gives each head of a GQA group of ``rep`` a block of its
    own: when its ``units`` (key tile, batch, KV head) blocks, each walking
    the group, would leave some of the card's ``sms`` SMs idle. A function
    of the shape and the card only."""
    return rep > 1 and units < sms


def dkv_block_order(sk: int, b: int, hkv: int, rep: int, sms: int):
    """(key tile, batch, KV head, first head of the group, heads) of each
    block of K8's grid, in launch order (the kernels' ``dkv_block``): the
    key tile slowest, so every (batch, KV head) of key tile 0, which the
    most query rows see under the causal mask, launches first; each block
    walks the whole group, or with ``dkv_split`` one head, the group's
    ``rep`` blocks adjacent."""
    n_bh = b * hkv
    units = -(-sk // DKV_KEYS) * n_bh
    per = rep if dkv_split(units, rep, sms) else 1
    out = []
    for x in range(units * per):
        u = x // per
        out.append((u // n_bh, (u % n_bh) // hkv, u % hkv,
                    x % per if per > 1 else 0, 1 if per > 1 else rep))
    return out


def dkv_workspace_floats(units: int, rep: int, d: int) -> int:
    """fp32 floats of the split K8's partials: for each of the ``rep``
    heads of each of the ``units`` (key tile, batch, KV head), its block's
    dV and dK accumulators (64 keys x the kernels' columns each), stored in
    the threads' register order."""
    return units * rep * 2 * DKV_KEYS * kernel_dim(d)


def fwd_workspace(b: int, sk: int, hkv: int, d: int,
                  device: torch.device) -> torch.Tensor:
    """The fp32 workspace of K6 and K10 with fp32 q: K and V split once
    per call into the hi/lo tf32 planes of every 32-key tile of every
    (batch, KV head) at the kernels' head dim, which all the query blocks
    of the head read. bf16 q takes none."""
    tiles = b * hkv * -(-sk // FWD_KEYS)
    return torch.empty(tiles * FWD_PLANES * FWD_KEYS * kernel_dim(d),
                       dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    """The C entry point ``name``, built and bound on first use (every
    pointer and the stream as ``c_void_p``)."""
    fn = getattr(build.load("flash_attention"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    n_ptr = {"flash_attention_fwd_launch": 6,
             "flash_attention_bwd_dq_launch": 7,
             "flash_attention_bwd_dkv_launch": 8,
             "flash_attention_launch": 7}[name]
    tail = {"flash_attention_launch": [i, i],
            "flash_attention_bwd_dkv_launch": [i, i, p, p]}.get(name, [i])
    fn.argtypes = [p] * n_ptr + [i] * 8 + [ctypes.c_float] + tail + [p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *rows: torch.Tensor, kv_int8: bool = False
           ) -> Tuple[int, int, int, int, int, int]:
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D) of one fp32/bf16 dtype (k/v
    int8 with ``kv_int8``), and per-query-row tensors (B, Sq, H, D) in q's
    dtype or (B, H, Sq) fp32, all contiguous on one card. Returns (B, Sq,
    Sk, H, Hkv, D)."""
    check_cuda(name, q, k, v, *rows)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not form a GQA group")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name} kernel: head_dim {d} not in {_HEAD_DIMS}")
    kv_dtype = torch.int8 if kv_int8 else q.dtype
    if q.dtype not in DTYPES or k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"{name} kernel takes fp32 or bf16 q with k, v in "
                        f"{'int8' if kv_int8 else 'its dtype'}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for t in (q, k, v) + rows:
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: every input must be "
                             f"contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: every input must be 16-byte "
                             f"aligned")
    for t in rows:
        want = ((q.shape, q.dtype) if t.dim() == 4
                else ((b, h, sq), torch.float32))
        if (t.shape, t.dtype) != want:
            raise ValueError(f"{name}: a row tensor is {tuple(t.shape)} "
                             f"{t.dtype}, wants {tuple(want[0])} {want[1]}")
    return b, sq, sk, h, hkv, d


def _statics(causal: bool, window: int, scale: float, q: torch.Tensor,
             *extra):
    return (int(bool(causal)), int(window), float(scale),
            int(q.dtype == torch.bfloat16), *extra,
            torch.cuda.current_stream(q.device).cuda_stream)


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True,
                        window: int = -1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6. q (B, Sq, H, D), k/v (B, Sk, Hkv, D) on a CUDA device, fp32 or
    bf16. Returns (out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) fp32);
    a row with no valid key is zeros with lse about -1e30."""
    name = "flash_attention_fwd"
    b, sq, sk, h, hkv, d = _check(name, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    if sk == 0:
        return out.zero_(), lse.fill_(-1e30)
    # the fp32 forward's workspace; bf16 q takes none
    ws = (fwd_workspace(b, sk, hkv, d, q.device)
          if q.dtype == torch.float32 else None)
    with torch.cuda.device(q.device):
        err = _launcher(name + "_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), ws.data_ptr() if ws is not None else None, b,
            sq, sk, h, hkv, d, *_statics(causal, window, scale, q))
    _raise_on(name, err)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_kernel[route(q.dtype, d)] += 1
    return out, lse


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, dout: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor, *,
                           scale: float, causal: bool = True,
                           window: int = -1) -> torch.Tensor:
    """K7. dout (B, Sq, H, D) in q's dtype, lse and delta = rowsum(dout *
    out) (B, H, Sq) fp32. Returns dq (B, Sq, H, D) in q's dtype."""
    name = "flash_attention_bwd_dq"
    b, sq, sk, h, hkv, d = _check(name, q, k, v, dout, lse, delta)
    kernel = route(q.dtype, d)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    if sk == 0:
        return dq.zero_()
    with torch.cuda.device(q.device):
        err = _launcher(name + "_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, sq, sk, h,
            hkv, d, *_statics(causal, window, scale, q))
    _raise_on(name, err)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.launches_by_kernel[kernel] += 1
    return dq


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor, *,
                            scale: float, causal: bool = True,
                            window: int = -1
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8. The inputs of K7. Returns (dk, dv) (B, Sk, Hkv, D) in k's and
    v's dtype, each summed over its GQA group inside the kernel (by the
    group's last block where ``dkv_split`` gives each head a block)."""
    name = "flash_attention_bwd_dkv"
    b, sq, sk, h, hkv, d = _check(name, q, k, v, dout, lse, delta)
    kernel = route(q.dtype, d)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    if sq == 0 or h == 0:
        return dk.zero_(), dv.zero_()
    rep = h // hkv
    units = -(-sk // DKV_KEYS) * b * hkv
    split = dkv_split(units, rep, _sm_count(q.device.index))
    ws = counters = None
    if split:
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters, ws = scratch(q.device, stream, units,
                               dkv_workspace_floats(units, rep, d))
    with torch.cuda.device(q.device):
        err = _launcher(name + "_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, sk, h, hkv, d,
            *_statics(causal, window, scale, q, int(split),
                      ws.data_ptr() if split else None,
                      counters.data_ptr() if split else None))
    _raise_on(name, err)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.launches_by_kernel[kernel] += 1
    return dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = -1,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10. q (B, Sq, H, D) fp32 or bf16 on a CUDA device; k/v (B, Sk,
    Hkv, D) in q's dtype, or int8 codes with ``k_scale``/``v_scale`` (B,
    Sk, Hkv) fp32. Returns out (B, Sq, H, D) in q's dtype; a row with no
    valid key is zeros."""
    name = "flash_attention"
    int8 = k_scale is not None
    if int8 != (v_scale is not None):
        raise ValueError(f"{name}: pass both KV scales or neither")
    b, sq, sk, h, hkv, d = _check(name, q, k, v, kv_int8=int8)
    if int8:
        check_cuda(name, q, k_scale, v_scale)
        for sc in (k_scale, v_scale):
            if sc.shape != k.shape[:3] or sc.dtype != torch.float32 \
                    or not sc.is_contiguous():
                raise ValueError(f"{name}: a KV scale is {tuple(sc.shape)} "
                                 f"{sc.dtype}, wants {tuple(k.shape[:3])} "
                                 f"fp32 contiguous")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()
    # the fp32 forward's workspace; bf16 q takes none
    ws = (fwd_workspace(b, sk, hkv, d, q.device)
          if q.dtype == torch.float32 else None)
    with torch.cuda.device(q.device):
        err = _launcher(name + "_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None, out.data_ptr(),
            ws.data_ptr() if ws is not None else None, b, sq, sk, h, hkv,
            d, int(bool(causal)),
            int(window), float(scale),
            int(q.dtype == torch.bfloat16), int(int8),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(name, err)
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[route(q.dtype, d)] += 1
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_kernel = {"tensor_cores": 0}
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_by_kernel = {"tensor_cores": 0}
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_by_kernel = {"tensor_cores": 0}
flash_attention.launches = 0
flash_attention.launches_by_kernel = {"tensor_cores": 0}
