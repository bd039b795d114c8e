"""mixtral-8x7b [moe] — arXiv:2401.04088; hf:mistralai/Mixtral-8x7B.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, 8 experts top-2,
sliding-window attention (4096).  SWA makes the decode cache O(window), so
long_500k RUNS for this arch.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1000000.0,
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=256, n_experts=4, experts_per_token=2,
        sliding_window=16, moe_group_size=64, capacity_factor=8.0,
        dtype="float32",
    )
