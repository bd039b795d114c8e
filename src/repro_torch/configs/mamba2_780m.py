"""mamba2-780m [ssm] — arXiv:2405.21060; unverified.

48L d_model=1536 (attention-free), ssm_state=128, vocab=50280, SSD layers
(expand=2, head_dim=64 -> 48 heads).  O(1) decode state -> long_500k RUNS.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,       # unused by the ssm family
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=32, dtype="float32",
    )
