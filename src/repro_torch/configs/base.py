"""Architecture + run configuration schema.

One ``ArchConfig`` instance fully determines a model: the 10 assigned
architectures each ship a module in this package (``repro/configs/<id>.py``)
instantiating their exact published shape, plus a ``smoke()`` reduction
(<=2 layers, d_model<=512, <=4 experts) used by the CPU tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

from repro_torch.core.fediac import FediACConfig


@dataclass(frozen=True)
class ArchConfig:
    # identity ------------------------------------------------------------
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""               # citation for the shape

    # trunk ----------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4               # 0 for attention-free layers
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 32000
    act: str = "silu"              # silu(SwiGLU) | geglu(GeGLU)
    qk_norm: bool = False
    attn_kind: str = "gqa"         # gqa | mla | none
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6

    # MLA (DeepSeek-V2) ------------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0    # leading dense layers before the MoE stack
    d_ff_dense: int = 0            # their FFN width
    capacity_factor: float = 1.25

    # SSM (Mamba-2 SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_groups: int = 1
    conv_width: int = 4

    # layer mix / topology ---------------------------------------------------
    block_kind: str = "attn"       # attn | ssm | hybrid (per-layer body)
    encoder_layers: int = 0        # >0 => encoder-decoder (whisper)
    frontend: str = "none"         # none | audio_stub | vision_stub
    source_len: int = 0            # encoder source length (frames/patches)

    # attention windows ------------------------------------------------------
    sliding_window: int = 0        # 0 = full attention
    long_decode_window: int = 8192  # ring-buffer window used for long_500k
    mla_absorbed: bool = False     # matrix-absorbed MLA decode (§Perf)
    attn_q_block: int = 2048       # blockwise-attention tile sizes (§Perf)
    attn_kv_block: int = 1024

    # numerics ----------------------------------------------------------
    tie_embeddings: bool = True
    scale_embed: bool = False      # gemma-style sqrt(d_model) embed scaling
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    grad_dtype: str = "float32"    # microbatch grad-accumulator dtype
    residual_dtype: str = "float32"  # FediAC error-feedback state dtype

    # distribution ----------------------------------------------------------
    fsdp: bool = False             # shard params over the data axis too
    act_shard: str = "feature"     # residual-stream storage sharding over the
                                   # model axis: feature | sequence | none
    remat_policy: str = "full"     # full | dots (save matmul outputs: fewer
                                   # recompute collectives, more memory)
    remat: bool = True
    microbatch: int = 1            # grad-accum splits of the per-client batch
    fl_local_steps: int = 1        # E (paper); >1 only when replicas fit

    # the paper's technique --------------------------------------------------
    fediac: FediACConfig = field(default_factory=FediACConfig)
    aggregator: str = "fediac"     # fediac | dense (paper-faithful vs FedAvg)

    # derived ----------------------------------------------------------------
    @property
    def qk_dim(self) -> int:
        if self.attn_kind == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}
