"""granite-3-8b [dense] — hf:ibm-granite/granite-3.0-8b-base.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155; tied embeddings
(HF config).  Full attention -> long_500k skip.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    tie_embeddings=True,
    rope_theta=10000.0,
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, dtype="float32",
    )
