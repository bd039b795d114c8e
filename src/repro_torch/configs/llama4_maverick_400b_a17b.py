"""llama4-maverick-400b-a17b [moe] — hf:meta-llama/Llama-4 family; unverified.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts
top-1.  Early fusion is multimodal plumbing outside the text backbone scope;
the assignment specifies the transformer backbone, which is what we build.
Full attention (no published sub-quadratic variant in the spec line) —
long_500k is skipped for this arch (see DESIGN.md §Arch-applicability).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    experts_per_token=1,
    rope_theta=500000.0,
)


def reduced():
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=256, n_experts=8, experts_per_token=1,
        moe_group_size=64, capacity_factor=8.0, dtype="float32",
    )
