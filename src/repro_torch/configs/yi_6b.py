"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
— llama-arch GQA  [arXiv:2403.04652]."""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="yi_6b", arch_type="dense", source="arXiv:2403.04652",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=11008, vocab=64000, act="silu", tie_embeddings=False,
        compute_dtype="bfloat16", microbatch=16,
        fl_local_steps=1,
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, compute_dtype="float32", microbatch=1)
