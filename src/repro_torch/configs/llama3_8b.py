"""llama3-8b [dense] — GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8,
    d_ff=14336, vocab=128256, rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=160, vocab=256,
    attn_chunk_q=64, attn_chunk_k=64, remat=False,
)
