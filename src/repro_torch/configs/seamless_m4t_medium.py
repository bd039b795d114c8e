"""seamless-m4t-medium [audio] — arXiv:2308.11596; hf:facebook/seamless-m4t.

Enc-dec: 12L encoder over audio-frame embeddings (frontend STUBBED per the
assignment: input_specs() provides precomputed frame embeddings) + 12L
decoder, d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206, GeLU MLP.
Enc-dec full attention -> long_500k skip; decode_32k uses the decoder
self-attn cache + fixed cross-attn memory.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    mlp_type="gelu",
    encoder_layers=12,
    audio_frames=4096,
    audio_dim=1024,
)


def reduced():
    return CONFIG.replace(
        n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, audio_frames=24, audio_dim=32,
        dtype="float32",
    )
