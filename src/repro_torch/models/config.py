"""Model + workload-shape configuration.

Twin of ``src/repro/models/config.py``, field for field (the port's
``param_specs`` counts the parameters).

One ``ModelConfig`` describes any of the 10 assigned architectures (plus
reduced smoke variants). One ``ShapeSpec`` describes an assigned workload
shape (train_4k / prefill_32k / decode_32k / long_500k).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 1024       # tokens per dispatch group
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0         # zamba2: shared attn block every k layers
    # --- xLSTM ---
    slstm_every: int = 0        # 1 sLSTM per k blocks (rest mLSTM)
    mlstm_proj: int = 2
    # --- modality stubs ---
    n_codebooks: int = 0        # musicgen: EnCodec streams
    patch_tokens: int = 0       # internvl2: prefix patch embeddings
    # --- numerics / memory ---
    pad_vocab_to: int = 128     # embedding rows padded for clean TP shards
    dtype: str = "bfloat16"     # activation/compute dtype
    # attention implementation: "xla" (blockwise torch-op flash, runs
    # anywhere) | "pallas" (the hand-written K7 CUDA kernel on a CUDA
    # tensor, its plain version on a CPU one); the names are the
    # reference's
    attn_impl: str = "xla"
    remat: bool = True          # per-layer activation checkpointing
    attn_chunk_q: int = 1024    # flash-attention tile sizes (the kernel
    attn_chunk_k: int = 1024    # picks its own; these set the padding)
    ssd_chunk: int = 256        # mamba2 / mLSTM chunk length
    norm_eps: float = 1e-5

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding/lm-head rows: vocab rounded up so the TP axis always
        divides (real token ids stay < vocab; the pad rows are dead weight,
        the standard production trade)."""
        p = self.pad_vocab_to
        return (self.vocab + p - 1) // p * p

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:           # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Exact parameter count, summed from the param-spec table (the
        same source init/sharding/dry-run use)."""
        import math

        from repro_torch.models.model import param_specs  # late: cycle
        return sum(math.prod(s.shape)
                   for s in param_specs(self).values())

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k of the expert FFN
        weights participate per token)."""
        import math

        from repro_torch.models.model import param_specs
        total = 0
        for k, s in param_specs(self).items():
            n = math.prod(s.shape)
            if self.is_moe and "/moe/w" in k:
                n = n * self.top_k // self.n_experts
            total += n
        return total


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
