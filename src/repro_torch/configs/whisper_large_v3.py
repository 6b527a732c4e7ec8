"""whisper-large-v3 [audio]: enc-dec, 32+32L d_model=1280 20H d_ff=5120
vocab=51866; the conv frontend is a stub (the encoder takes precomputed
mel-frame embeddings). [arXiv:2212.04356; unverified]

Mirror of ``repro.configs.whisper_large_v3``: 20 heads of 64, 1500 audio
frames, GELU MLPs, QKV biases. ``sp_attention`` (the reference's
context-parallel attention for 20 heads on a 16-way mesh axis) is carried
and read by nothing on one card. The decoder's self-attention takes the
flash route (K6-K8) at head dim 64, the smoke config's at 16.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.encdec import EncDecConfig


def make_config() -> EncDecConfig:
    return EncDecConfig(
        name="whisper-large-v3",
        n_enc_layers=32, n_dec_layers=32,
        d_model=1280, n_heads=20, d_ff=5120, vocab=51866,
        n_audio_ctx=1500, act="gelu",
        sp_attention=True,
    )


def make_smoke() -> EncDecConfig:
    return EncDecConfig(
        name="whisper-smoke",
        n_enc_layers=2, n_dec_layers=2,
        d_model=64, n_heads=4, d_ff=128, vocab=128,
        n_audio_ctx=16, act="gelu",
    )


SPEC = ArchSpec(
    arch_id="whisper-large-v3", family="audio", kind="encdec",
    make_config=make_config, make_smoke=make_smoke,
    params_nominal=1.55e9, long_context_ok=False,
    source="arXiv:2212.04356; unverified",
    notes="modality frontend stubbed: the encoder takes (B, 1500, d) frame "
          "embeddings; decode_step's self cache is sized by its caller "
          "(448 tokens is whisper's design length)",
)
