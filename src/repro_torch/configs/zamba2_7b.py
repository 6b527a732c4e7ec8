"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
ssm_state=64 — Mamba2 blocks + shared attention blocks.
[arXiv:2411.15242; unverified]

Mirror of ``repro.configs.zamba2_7b``: 13 x (5 mamba + 1 shared-attn
invocation) + 3 mamba tail = 81 layer slots with ONE shared attention/MLP
parameter set (real zamba2 alternates two shared blocks with per-site
LoRA — the reference's simplification, DESIGN.md §10). Each of the 13
shared sites keeps its own KV cache; their decode attention is K1 on the
card at 32 heads on 32 KV heads of 112 (the SIMT kernel). Dense path
only, as in the reference.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.ssd import SSDConfig
from repro_torch.models.transformer import BlockSpec, LMConfig

_M = BlockSpec(kind="ssd", has_ffn=False)
_A = BlockSpec(kind="attn", shared_attn=True)


def make_config() -> LMConfig:
    return LMConfig(
        name="zamba2-7b",
        d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
        head_dim=112,
        pattern=(_M, _M, _M, _M, _M, _A), repeats=13,
        tail=(_M, _M, _M),
        ssd_cfg=SSDConfig(d_model=3584, d_state=64, head_dim=64, expand=2,
                          n_groups=1, d_conv=4, chunk=256),
        act="gelu", rope_theta=10000.0,
        tie_embeddings=True,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="zamba2-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, head_dim=16,
        pattern=(_M, _M, _A), repeats=2, tail=(_M,),
        ssd_cfg=SSDConfig(d_model=64, d_state=16, head_dim=16, expand=2,
                          n_groups=1, d_conv=4, chunk=8),
        act="gelu",
    )


SPEC = ArchSpec(
    arch_id="zamba2-7b", family="hybrid", kind="lm",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=7e9, long_context_ok=True,
    source="arXiv:2411.15242; unverified",
    notes="sub-quadratic (SSM backbone; 13 attention sites) -> long_500k "
          "runs; decode state = SSD states + 13 shared-attn KV slots",
)
