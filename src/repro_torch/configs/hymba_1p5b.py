"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attn+mamba heads  [arXiv:2411.13676].

Attention heads run sliding-window (2048) as in the paper (global context is
carried by the SSM path), which makes long_500k decode native: ring-buffer
attn cache + O(1) SSM state.
"""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="hymba_1p5b", arch_type="hybrid", source="arXiv:2411.13676",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab=32001, act="silu", block_kind="hybrid",
        sliding_window=2048, long_decode_window=2048,
        ssm_state=16, ssm_heads=25, ssm_head_dim=128, ssm_groups=5,
        ssm_chunk=256, attn_q_block=512, attn_kv_block=512,
        tie_embeddings=True, param_dtype="bfloat16", compute_dtype="bfloat16",
        microbatch=8,
        fl_local_steps=4,
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=160, n_heads=5, n_kv_heads=5, head_dim=32,
        d_ff=256, vocab=512, sliding_window=32, long_decode_window=32,
        ssm_state=8, ssm_heads=5, ssm_head_dim=32, ssm_groups=5,
        ssm_chunk=8, param_dtype="float32", compute_dtype="float32", microbatch=1)
