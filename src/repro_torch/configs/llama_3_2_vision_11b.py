"""llama-3.2-vision-11b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision; unverified.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, gated cross-attn
image blocks after every 5th self layer.  Per the assignment the modality
frontend is a STUB: ``input_specs()`` provides precomputed patch embeddings
(vision_tokens x vision_dim); the backbone projects + cross-attends them.
Full attention -> long_500k skip.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_every=5,
    vision_dim=1280,
    vision_tokens=1600,
    rope_theta=500000.0,
)


def reduced():
    return CONFIG.replace(
        n_layers=4, cross_every=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, vision_dim=32, vision_tokens=16,
        dtype="float32",
    )
