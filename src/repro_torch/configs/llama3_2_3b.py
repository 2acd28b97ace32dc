"""llama3.2-3b [dense] — small llama3. [hf:meta-llama/Llama-3.2; unverified]
24 query heads: does NOT divide the 16-way model axis -> the adaptive
rules drop the head activation constraint (params still TP on H*hd=3072).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv=8,
    d_ff=8192, vocab=128256, rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama32-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv=2,
    d_ff=192, vocab=256,
    attn_chunk_q=64, attn_chunk_k=64, remat=False,
)
