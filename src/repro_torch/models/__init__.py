"""Model zoo of the port: configurations of the 10 assigned architectures,
and the dense decoder (prefill, decode) in PyTorch."""

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES"]
