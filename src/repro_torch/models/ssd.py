"""Mamba2 / SSD (state-space duality) blocks of the PyTorch port (mirror of
``repro.models.ssd``; arXiv:2405.21060).

The chunked SSD algorithm serves the full-sequence passes (``forward``,
``prefill``): quadratic within a chunk, a sequential scan over the chunks.
The one-token recurrent form serves decode. Both are plain torch, as they
are XLA in the reference; no Pallas kernel reaches them.

Block layout (Mamba2):
  in: separate projections z, x, B, C, dt
  causal depthwise conv (width d_conv) over x, B, C
  SSD core:  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
             y_t = C_t h_t + D x_t
  gated RMSNorm(y * silu(z)) -> out projection

``ssd_block_decode`` updates its ``SSDState`` in place (the conv windows
and the fp32 state): the counterpart of the JAX tick donating its caches,
as the KV write is an ``index_put_``. A conv state stored in a narrower
dtype than the block's inputs is written in that dtype; the reference's
``jnp.concatenate`` promotes it to the inputs' dtype instead (ROADMAP
queue 3, "differences by design").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common, layers


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_model: int
    d_state: int = 128          # N
    head_dim: int = 64          # P
    expand: int = 2
    n_groups: int = 1           # G (B, C shared per group)
    d_conv: int = 4
    chunk: int = 256            # SSD chunk length (training / prefill)
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s operations in x's dtype, x * (1 / (1 + exp(-x))),
    each rounded to that dtype as XLA's expansion of the logistic rounds
    it (``F.silu`` rounds once: a bf16 ulp apart, which the gated norm
    and out projection grow to percents)."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, log(1 + e^x) without a threshold
    (``F.softplus`` returns x itself past 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_ssd(cfg: SSDConfig, lead=(), *, generator: torch.Generator,
             device, dtype=torch.float32) -> dict:
    """The reference's leaves and distributions (ssd.py:52-83), behind the
    ``lead`` stack dims: fan-in projections, the inverse-softplus
    ``dt_bias`` of a log-uniform dt in [dt_min, dt_max], ``a_log =
    log(linspace(1, 16, H))``, ``d_skip`` ones (all three fp32),
    ``conv_x`` truncated normal of 0.2, ``conv_b`` and ``conv_c`` zeros
    (so B and C are silu(0) = 0 and the state path starts dead), the inner
    norm's scale ones in ``dtype``. The draws are torch's."""
    lead = tuple(lead)
    d, h, p, g, n = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_groups,
                     cfg.d_state)
    kw = dict(generator=generator, device=device, dtype=dtype)
    u = torch.empty(lead + (h,), dtype=torch.float32, device=device)
    u.uniform_(generator=generator)
    dt_init = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                        + math.log(cfg.dt_min))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inverse softplus
    a_init = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                      device=device))
    w = cfg.d_conv
    return {
        "w_z": common.fan_in_init(lead + (d, h, p), fan_in=d, **kw),
        "w_x": common.fan_in_init(lead + (d, h, p), fan_in=d, **kw),
        "w_b": common.fan_in_init(lead + (d, g, n), fan_in=d, **kw),
        "w_c": common.fan_in_init(lead + (d, g, n), fan_in=d, **kw),
        "w_dt": common.fan_in_init(lead + (d, h), fan_in=d, **kw),
        "dt_bias": dt_bias,
        "a_log": a_init.expand(lead + (h,)).clone(),
        "d_skip": torch.ones(lead + (h,), dtype=torch.float32, device=device),
        "conv_x": common.trunc_normal(lead + (w, h, p), 0.2, **kw),
        "conv_b": torch.zeros(lead + (w, g, n), dtype=dtype, device=device),
        "conv_c": torch.zeros(lead + (w, g, n), dtype=dtype, device=device),
        "norm": {"scale": torch.ones(lead + (h * p,), dtype=dtype,
                                     device=device)},
        "w_out": common.fan_in_init(lead + (h, p, d), fan_in=h * p, **kw),
    }


# -----------------------------------------------------------------------------
# causal depthwise conv (width d_conv), full-sequence and incremental forms
# -----------------------------------------------------------------------------

def _causal_dwconv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x (B, S, ...ch), kernel (W, ...ch): y_t = sum_i k_i x_{t-W+1+i},
    zeros before the start, multiplied and added in x's dtype."""
    w, s = kernel.shape[0], x.shape[1]
    y = x * kernel[-1].to(x.dtype)
    for i in range(w - 1):
        shift = w - 1 - i
        xs = torch.cat([x.new_zeros((x.shape[0], shift) + x.shape[2:]), x],
                       dim=1)[:, :s]
        y = y + xs * kernel[i].to(x.dtype)
    return y


def _dwconv_step(x_new: torch.Tensor, conv_state: torch.Tensor,
                 kernel: torch.Tensor) -> torch.Tensor:
    """x_new (B, 1, ...ch), conv_state (B, W-1, ...ch) past inputs: the
    conv's output at the new token, summed in fp32 and cast to x_new's
    dtype; the state slides by one in place (the new input enters in the
    state's dtype)."""
    dt = torch.promote_types(conv_state.dtype, x_new.dtype)
    window = torch.cat([conv_state.to(dt), x_new.to(dt)], dim=1)  # (B, W, ...)
    y = torch.einsum("bw...,w...->b...", window.float(),
                     kernel.float())[:, None]
    conv_state.copy_(window[:, 1:])
    return y.to(x_new.dtype)


# -----------------------------------------------------------------------------
# SSD core
# -----------------------------------------------------------------------------

def ssd_naive(x, dt, a, b_mat, c_mat, init_state=None):
    """The O(S·N·P) recurrence, the tests' oracle, in fp32.

    x (B, S, H, P), dt (B, S, H), a (H,), b/c (B, S, H, N) (already
    group-expanded) -> y (B, S, H, P), final state (B, H, N, P)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    f32 = torch.float32
    state = (torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    x, dt, b_mat, c_mat = (t.to(f32) for t in (x, dt, b_mat, c_mat))
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                         # (B, H)
        xbar = x[:, t] * dt[:, t, :, None]                      # (B, H, P)
        state = (decay[..., None, None] * state
                 + torch.einsum("bhn,bhp->bhnp", b_mat[:, t], xbar))
        ys.append(torch.einsum("bhn,bhnp->bhp", c_mat[:, t], state))
    y = (torch.stack(ys, 1) if ys
         else x.new_zeros((bsz, 0, h, p)))
    return y, state


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, init_state=None):
    """Chunked SSD (Mamba2 alg. 1): quadratic within a chunk, a linear scan
    over the chunks, in fp32. Shapes as ``ssd_naive``. A sequence that is
    no multiple of ``chunk`` is padded at its tail with dt = 0 (decay 1,
    no input), which leaves the states as they are (ssd.py:151-161)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if s % chunk != 0:
        pad = chunk - s % chunk
        y, final = ssd_chunked(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), a,
            F.pad(b_mat, (0, 0, 0, 0, 0, pad)),
            F.pad(c_mat, (0, 0, 0, 0, 0, pad)), chunk, init_state)
        return y[:, :s], final
    nc = s // chunk
    f32 = torch.float32

    # (B, nc, H, Q, ...)
    xc = x.to(f32).reshape(bsz, nc, chunk, h, p).transpose(2, 3)
    dtc = dt.to(f32).reshape(bsz, nc, chunk, h).transpose(2, 3)
    bc = b_mat.to(f32).reshape(bsz, nc, chunk, h, n).transpose(2, 3)
    cc = c_mat.to(f32).reshape(bsz, nc, chunk, h, n).transpose(2, 3)

    da = dtc * a[None, None, :, None]                   # (B, nc, H, Q) <= 0
    cum = torch.cumsum(da, dim=-1)                      # cumulative log-decay
    xbar = xc * dtc[..., None]

    # intra-chunk (masked quadratic, attention-like form). The mask goes
    # on the exponent: above the diagonal cum_q - cum_k is positive and
    # passes fp32's exp range once a chunk's log-decay sums past ~88 (at
    # chunk 256), and exp(inf) times the masked zero gradient is a NaN in
    # the backward; exp(-inf) is the same 0 forward with a zero gradient
    # (the reference's where after the exp has the NaN, ssd.py:178)
    ldiff = cum[..., :, None] - cum[..., None, :]       # (B, nc, H, Q, Q)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    l_mat = torch.exp(torch.where(tri, ldiff, float("-inf")))
    del ldiff
    scores = torch.einsum("bchqn,bchkn->bchqk", cc, bc) * l_mat
    del l_mat
    y_intra = torch.einsum("bchqk,bchkp->bchqp", scores, xbar)
    del scores

    # chunk-final states: S_c = sum_j exp(cum_Q - cum_j) B_j (x̄_j)^T
    decay_to_end = torch.exp(cum[..., -1:] - cum)       # (B, nc, H, Q)
    s_chunk = torch.einsum("bchqn,bchqp->bchnp",
                           bc * decay_to_end[..., None], xbar)
    chunk_decay = torch.exp(cum[..., -1])               # (B, nc, H)

    # inter-chunk recurrence over the nc chunks: the state entering each
    hprev = (torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = chunk_decay[:, c, :, None, None] * hprev + s_chunk[:, c]
    h_in = torch.stack(h_in, 1)                         # (B, nc, H, N, P)

    y_inter = torch.einsum("bchqn,bchnp->bchqp",
                           cc * torch.exp(cum)[..., None], h_in)
    y = (y_intra + y_inter).transpose(2, 3).reshape(bsz, s, h, p)
    return y, hprev


# -----------------------------------------------------------------------------
# Block-level apply
# -----------------------------------------------------------------------------

@dataclasses.dataclass
class SSDState:
    """A block's decode state, (B, ...) behind any stacked layer dims:
    the last W-1 pre-activation conv inputs in the cache dtype, and the SSM
    state in fp32."""
    conv_x: torch.Tensor     # (B, W-1, H, P)
    conv_b: torch.Tensor     # (B, W-1, G, N)
    conv_c: torch.Tensor     # (B, W-1, G, N)
    ssm: torch.Tensor        # (B, H, N, P)

    def tensors(self):
        return [self.conv_x, self.conv_b, self.conv_c, self.ssm]


SSD_LEAVES = ("conv_x", "conv_b", "conv_c", "ssm")


def init_ssd_state(cfg: SSDConfig, batch: int, dtype=torch.bfloat16,
                   device="cpu", lead=()) -> SSDState:
    lead = tuple(lead) + (batch,)
    h, p, g, n, w = (cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state,
                     cfg.d_conv)
    return SSDState(
        conv_x=torch.zeros(lead + (w - 1, h, p), dtype=dtype, device=device),
        conv_b=torch.zeros(lead + (w - 1, g, n), dtype=dtype, device=device),
        conv_c=torch.zeros(lead + (w - 1, g, n), dtype=dtype, device=device),
        ssm=torch.zeros(lead + (h, n, p), dtype=torch.float32,
                        device=device))


def _expand_groups(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N), each group repeated H/G times."""
    bsz, s, g, n = t.shape
    return t[:, :, :, None, :].expand(bsz, s, g, n_heads // g, n).reshape(
        bsz, s, n_heads, n)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,d...->bs...", x, w) in x's dtype."""
    out = w.shape[1:]
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).reshape(
        x.shape[:-1] + out)


def _projections(params, cfg: SSDConfig, x: torch.Tensor):
    return (_proj(x, params["w_z"]), _proj(x, params["w_x"]),
            _proj(x, params["w_b"]), _proj(x, params["w_c"]),
            _proj(x, params["w_dt"]))


def _dt_a(params, dt_raw: torch.Tensor):
    """(dt = softplus(dt_raw + dt_bias) in fp32, A = -exp(a_log))."""
    return (softplus(dt_raw.float() + params["dt_bias"]),
            -torch.exp(params["a_log"]))


def _finish(params, cfg: SSDConfig, y: torch.Tensor, xin: torch.Tensor,
            z: torch.Tensor) -> torch.Tensor:
    """The D skip, the silu(z) gate, the gated RMSNorm (``layers.rms_norm``
    over the H * P inner width) and the out projection."""
    y = y + params["d_skip"][None, None, :, None] * xin.float()
    y = y.to(z.dtype) * silu(z)
    bsz, s = y.shape[:2]
    y = layers.rms_norm(params["norm"], y.reshape(bsz, s, -1))
    w_out = params["w_out"].to(y.dtype)
    return y @ w_out.reshape(-1, w_out.shape[-1])


def ssd_scan(params, cfg: SSDConfig, z, xin, b_raw, c_raw, dt_raw):
    """The full-sequence block from its projections: the convs, the chunked
    core and ``_finish``. Returns (y (B, S, d_model), final SSM state)."""
    xin_c = silu(_causal_dwconv(xin, params["conv_x"]))
    b_c = silu(_causal_dwconv(b_raw, params["conv_b"]))
    c_c = silu(_causal_dwconv(c_raw, params["conv_c"]))
    dt, a = _dt_a(params, dt_raw)
    bm = _expand_groups(b_c, cfg.n_heads).float()
    cm = _expand_groups(c_c, cfg.n_heads).float()
    y, final = ssd_chunked(xin_c.float(), dt, a, bm, cm, cfg.chunk)
    return _finish(params, cfg, y, xin_c, z), final


def ssd_block(params, cfg: SSDConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence (training / prefill) Mamba2 block. x (B, S, D)."""
    return ssd_scan(params, cfg, *_projections(params, cfg, x))[0]


def ssd_block_decode(params, cfg: SSDConfig, x: torch.Tensor,
                     state: SSDState) -> Tuple[torch.Tensor, SSDState]:
    """One-token decode. x (B, 1, D) -> (out (B, 1, D), ``state``), the
    state updated in place."""
    z, xin, b_raw, c_raw, dt_raw = _projections(params, cfg, x)
    xin = silu(_dwconv_step(xin, state.conv_x, params["conv_x"]))
    b_raw = silu(_dwconv_step(b_raw, state.conv_b, params["conv_b"]))
    c_raw = silu(_dwconv_step(c_raw, state.conv_c, params["conv_c"]))
    dt, a = _dt_a(params, dt_raw)                                 # (B, 1, H)
    bm = _expand_groups(b_raw, cfg.n_heads).float()[:, 0]         # (B, H, N)
    cm = _expand_groups(c_raw, cfg.n_heads).float()[:, 0]
    dt0 = dt[:, 0]                                                # (B, H)
    decay = torch.exp(dt0 * a)
    xbar = xin.float()[:, 0] * dt0[..., None]                     # (B, H, P)
    ssm = (decay[..., None, None] * state.ssm
           + torch.einsum("bhn,bhp->bhnp", bm, xbar))
    state.ssm.copy_(ssm)
    y = torch.einsum("bhn,bhnp->bhp", cm, ssm)[:, None]           # (B,1,H,P)
    return _finish(params, cfg, y, xin, z), state
