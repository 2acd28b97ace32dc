"""internvl2-2b [vlm] — InternLM2 backbone + InternViT frontend stub.
[arXiv:2404.16821; hf]

Per assignment the modality frontend is a STUB: input_specs() supplies
precomputed (B, 256, d_model) patch embeddings (InternViT-300M @448px with
pixel-shuffle -> 256 tokens) prepended to the text sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8,
    d_ff=8192, vocab=92553, rope_theta=1_000_000.0,
    patch_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=128, vocab=250, patch_tokens=8,
    attn_chunk_q=64, attn_chunk_k=64, remat=False,
)
