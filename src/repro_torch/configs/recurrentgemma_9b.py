"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin); unverified.

38L d_model=4096 16H (MQA kv=1, head_dim 256) d_ff=12288 vocab=256000;
RG-LRU recurrent blocks + local attention in a 1:2 pattern (attn_every=3),
lru_width=4096, local window 2048.  Bounded state -> long_500k RUNS.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    attn_every=3,
    lru_width=4096,
    local_window=2048,
    tie_embeddings=True,
)


def reduced():
    return CONFIG.replace(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=256, lru_width=64, local_window=16, dtype="float32",
    )
