"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 — kimi/moonlight family.
[hf:moonshotai/Moonlight-16B-A3B; hf]

Mirror of ``repro.configs.moonshot_v1_16b_a3b``. The config as assigned
computes ~27B total / ~3.3B active parameters; the "16b" headline disagrees
with the assigned layer count, and the assigned config is the contract.
The TPU knob ``remat`` has no counterpart on one card and is left out;
``moe_group_size`` is kept, since it changes which routes drop.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import BlockSpec, LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b",
        d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840,
        head_dim=128,
        pattern=(BlockSpec(moe=True),), repeats=48,
        moe_cfg=MoEConfig(d_model=2048, d_ff=1408, n_experts=64, top_k=6,
                          capacity_factor=1.25),
        act="silu", rope_theta=50000.0,
        tie_embeddings=True, moe_group_size=4096,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="moonshot-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=128, head_dim=16,
        pattern=(BlockSpec(moe=True),), repeats=2,
        moe_cfg=MoEConfig(d_model=64, d_ff=96, n_experts=8, top_k=2,
                          capacity_factor=2.0),
        act="silu", moe_group_size=64,
    )


SPEC = ArchSpec(
    arch_id="moonshot-v1-16b-a3b", family="moe", kind="lm",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=16e9, long_context_ok=False,
    active_fraction=6.0 / 64.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
    notes="64 experts shard 4-per-rank on the 16-way model axis; "
          "full attention -> long_500k skipped",
)
