"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000 — GQA, no-bias  [hf:CohereForAI/c4ai-command-r-plus].

Largest *dense* update vector of the pool — the arch where FediAC's
collective compression matters most.  E=1 + FSDP (DESIGN.md §2).
"""

from repro_torch.core.fediac import FediACConfig

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="command_r_plus_104b", arch_type="dense",
        source="hf:CohereForAI/c4ai-command-r-plus",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
        d_ff=33792, vocab=256000, act="silu", tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        grad_dtype="bfloat16", residual_dtype="bfloat16",
        fediac=FediACConfig(vote_chunk=4096, work_dtype="bfloat16",
                            granularity="tensor"),
        fsdp=True, microbatch=8, fl_local_steps=1,
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, head_dim=32,
        d_ff=384, vocab=512, param_dtype="float32", compute_dtype="float32",
        fsdp=False, microbatch=1)
