"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

Mirror of ``repro.configs.gemma3_27b``. Head dim 5376 / 32 = 168. The
TPU knob ``remat`` of the original has no counterpart on one card and is
left out.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import BlockSpec, LMConfig

WINDOW = 1024  # gemma3 local sliding window

_LOCAL = BlockSpec(kind="attn", window=WINDOW)
_GLOBAL = BlockSpec(kind="attn", window=-1)


def make_config() -> LMConfig:
    # 62 layers = 10 x (5 local + 1 global) + 2 local tail
    return LMConfig(
        name="gemma3-27b",
        d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504, vocab=262144,
        pattern=(_LOCAL,) * 5 + (_GLOBAL,), repeats=10,
        tail=(_LOCAL, _LOCAL),
        act="gelu", rope_theta=10000.0, logit_softcap=0.0,
        tie_embeddings=True,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="gemma3-smoke",
        d_model=96, n_heads=4, n_kv_heads=2, d_ff=192, vocab=128,
        pattern=(BlockSpec(window=8),) * 2 + (BlockSpec(window=-1),),
        repeats=2, tail=(BlockSpec(window=8),),
        act="gelu",
    )


SPEC = ArchSpec(
    arch_id="gemma3-27b", family="dense", kind="lm",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=27e9, long_context_ok=True,
    source="hf:google/gemma-3-1b-pt (family); unverified",
    notes="5:1 local(1024):global; long_500k runs (sub-quadratic local layers "
          "+ 10 global layers with sharded KV); ring_cache hillclimb target",
)
