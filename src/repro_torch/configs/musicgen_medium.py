"""musicgen-medium [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]

4 EnCodec codebooks, vocab 2048 each: sum-of-embeddings in, 4 parallel LM
heads out. The EnCodec frontend + delay pattern are data-layer stubs per
the assignment (input_specs() carries precomputed frame token ids).
kv=24 == n_heads -> effectively MHA.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv=24,
    d_ff=6144, vocab=2048, rope_theta=10_000.0,
    n_codebooks=4,
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, vocab=64, n_codebooks=2,
    attn_chunk_q=64, attn_chunk_k=64, remat=False,
)
