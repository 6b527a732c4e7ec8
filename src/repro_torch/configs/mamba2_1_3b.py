"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]

Mirror of ``repro.configs.mamba2_1_3b``: 48 SSD blocks of 64 heads of 64
(d_inner 4096), state 128, one B/C group, conv width 4, chunk 256. No
attention, so it launches none of the serve path's kernels; it serves on
the dense path only (the paged path refuses SSD archs, as the reference's
does). The TPU knob ``remat`` has no counterpart on one card.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.ssd import SSDConfig
from repro_torch.models.transformer import BlockSpec, LMConfig

_M = BlockSpec(kind="ssd", has_ffn=False)


def make_config() -> LMConfig:
    return LMConfig(
        name="mamba2-1.3b",
        d_model=2048, n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280,
        pattern=(_M,), repeats=48,
        ssd_cfg=SSDConfig(d_model=2048, d_state=128, head_dim=64, expand=2,
                          n_groups=1, d_conv=4, chunk=256),
        pos_emb="none", act="silu",
        tie_embeddings=True,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="mamba2-smoke",
        d_model=64, n_heads=1, n_kv_heads=1, d_ff=0, vocab=128,
        pattern=(_M,), repeats=3,
        ssd_cfg=SSDConfig(d_model=64, d_state=16, head_dim=16, expand=2,
                          n_groups=1, d_conv=4, chunk=8),
        pos_emb="none",
    )


SPEC = ArchSpec(
    arch_id="mamba2-1.3b", family="ssm", kind="lm",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=1.3e9, long_context_ok=True,
    source="arXiv:2405.21060; unverified",
    notes="attention-free: flash-attention kernel inapplicable (SSD "
          "chunked path instead — DESIGN.md §8); long_500k runs (O(1) "
          "decode state)",
)
