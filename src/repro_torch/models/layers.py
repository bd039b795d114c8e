"""Shared building blocks: norms, RoPE, MLPs, initializers.

The port of :mod:`repro.models.layers`.  A ``torch.Generator`` takes the
place of a JAX key: parameters are drawn from it in a fixed order, on the
generator's device, so a model initializes on the card without a copy.
On the ``meta`` device (:func:`repro_torch.models.api.abstract_params`)
the helpers make empty tensors of the same shapes and dtypes and draw
nothing.  The spec functions (``*_specs``) give each parameter's logical
axes, and :func:`mlp` places the reference's sharding constraints and manual
tensor-parallel regions (:mod:`repro_torch.sharding`), which act only
under a mesh.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import (
    constrain, proj, seq_matmuls, tp_ag_matmuls, tp_rs_matmul,
)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------- init utils
def trunc_normal(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    """Normal truncated to [-2, 2], times sqrt(scale / fan_in), drawn in f32
    on ``gen``'s device and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    std = (scale / max(fan_in, 1)) ** 0.5
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if x.device.type == "meta":
        return x.to(dtype)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.mul_(std).to(dtype)


def zeros(shape, dtype, gen: torch.Generator) -> torch.Tensor:
    """Zeros on ``gen``'s device (biases and norm weights start at 0)."""
    return torch.zeros(shape, dtype=dtype, device=gen.device)


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """RMSNorm with a ``(1 + w)`` gain (``w`` starts at 0, Gemma-style)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + w.to(torch.float32))).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * w.to(torch.float32) + b.to(torch.float32)).to(dt)


# ---------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding, half-split (not interleaved).

    x: (..., S, H, hd); positions: (..., S).
    """
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.pow(
        theta, -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1f = x[..., :half].to(torch.float32)
    x2f = x[..., half:].to(torch.float32)
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- MLPs
def init_mlp(gen: torch.Generator, cfg, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg.dtype)
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": trunc_normal(gen, (d, f), 1.0, dt),
            "w_up": trunc_normal(gen, (d, f), 1.0, dt),
            "w_down": trunc_normal(gen, (f, d), 1.0, dt),
        }
    p = {
        "w_up": trunc_normal(gen, (d, f), 1.0, dt),
        "w_down": trunc_normal(gen, (f, d), 1.0, dt),
    }
    if cfg.mlp_bias:
        p["b_up"] = zeros((f,), dt, gen)
        p["b_down"] = zeros((d,), dt, gen)
    return p


def mlp(p, x, cfg):
    """Feed-forward block: SwiGLU, or GeLU (tanh form, as ``jax.nn.gelu``)
    with optional biases.  Under a mesh, by ``cfg.tp_mode``: megatron,
    the hidden activation sharded over tp (a partial-sum reduction on the
    down projection); ulysses, the token stream stays sequence-sharded and
    the weights are gathered instead (:func:`~repro_torch.sharding.
    seq_matmuls`: no activation collective); megatron_rs, the sequence
    all-gather fused with the up/gate products and the down product's
    partial sums reduce-scattered onto the sequence by hand
    (:func:`~repro_torch.sharding.tp_ag_matmuls`, ``tp_rs_matmul``).
    Without a mesh every mode is the plain product."""
    mode = cfg.tp_mode
    hidden_spec = ("dp", "sp", None) if mode == "ulysses" else \
        ("dp", None, "tp")
    if mode == "megatron":
        ups, down = (lambda *ws: tuple(proj(x, w) for w in ws)), proj
    elif mode == "ulysses":
        ups, down = (lambda *ws: seq_matmuls(x, *ws)), \
            (lambda h, w: seq_matmuls(h, w)[0])
    else:
        ups, down = (lambda *ws: tp_ag_matmuls(x, *ws)), tp_rs_matmul
    if cfg.mlp_type == "swiglu":
        g, u = ups(p["w_gate"], p["w_up"])
        h = constrain(F.silu(g) * u, *hidden_spec)
        return down(h, p["w_down"])
    (h,) = ups(p["w_up"])
    if "b_up" in p:
        h = h + p["b_up"]
    h = constrain(F.gelu(h, approximate="tanh"), *hidden_spec)
    y = down(h, p["w_down"])
    if "b_down" in p:
        y = y + p["b_down"]
    return y


def mlp_specs(cfg):
    """Logical-axis tuples matching init_mlp's structure."""
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": ("fsdp", "tp"),
            "w_up": ("fsdp", "tp"),
            "w_down": ("tp", "fsdp"),
        }
    p = {"w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp")}
    if cfg.mlp_bias:
        p["b_up"] = ("tp",)
        p["b_down"] = (None,)
    return p
