"""starcoder2-15b [dense] — arXiv:2402.19173; hf:bigcode/starcoder2-15b.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152 — GQA, RoPE, GeLU
MLP with biases (the StarCoder2 recipe).  Full attention -> long_500k skip.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
    mlp_bias=True,
    qkv_bias=True,
    rope_theta=100000.0,
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, dtype="float32",
    )
