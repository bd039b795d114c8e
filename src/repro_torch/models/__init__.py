"""Model zoo of the port: configurations of the 10 assigned architectures,
and the decoder-only families (dense, moe, ssm, hybrid: prefill, decode)
in PyTorch."""

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES"]
