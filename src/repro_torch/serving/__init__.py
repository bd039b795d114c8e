"""Serving of the port: the batched LM engine.  The ROQ engine of the JAX
package (``repro/serving/roq.py`` and its router, admission and health
modules) is not ported yet (ROADMAP.md, queue 1 item 2)."""

from repro_torch.serving.engine import ServeEngine

__all__ = ["ServeEngine"]
