"""whisper-tiny [audio]: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 —
enc-dec, conv frontend STUB  [arXiv:2212.04356].

The mel-spectrogram + 2-conv frontend is stubbed per the assignment
carve-out: ``input_specs`` supplies precomputed frame embeddings
(B, 1500, 384).  long_500k is SKIPPED for this arch (enc-dec with a hard
30 s source bound; DESIGN.md §7).
"""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper_tiny", arch_type="audio", source="arXiv:2212.04356",
        n_layers=4, encoder_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        head_dim=64, d_ff=1536, vocab=51865, act="gelu",
        frontend="audio_stub", source_len=1500,
        tie_embeddings=True, microbatch=8,
        fl_local_steps=5,
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, encoder_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=512, source_len=64, microbatch=1)
