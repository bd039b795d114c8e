"""Front door of the port::

    from repro_torch.api import build_basis

    basis = build_basis(source=S, tau=1e-6)        # runs on cuda, "auto"
    basis.eim()                                    # EIM nodes + interpolant
    basis.save("artifacts/basis")                  # durable artifact
"""

from repro_torch.api.artifact import ReducedBasis
from repro_torch.api.build import build_basis, device_memory_budget
from repro_torch.api.spec import STRATEGIES, ReductionSpec

__all__ = ["ReductionSpec", "ReducedBasis", "build_basis", "STRATEGIES",
           "device_memory_budget"]
