"""stablelm-3b [dense] — hf:stabilityai/stablelm family; unverified.

32L d_model=2560 32H (MHA: kv=32) d_ff=6912 vocab=50304.
Full attention -> long_500k skip.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, dtype="float32",
    )
