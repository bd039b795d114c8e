"""Front door of the port::

    from repro_torch.api import build_basis

    basis = build_basis(source=S, tau=1e-6)        # runs on cuda, "auto"
    basis.eim()                                    # EIM nodes + interpolant
    basis.save("artifacts/basis")                  # durable artifact

    bases = build_basis(source=S, strategy="batched",
                        tau=[1e-3, 1e-4, 1e-5])    # a ReducedBasisSet

    # on every rank of a group (repro_torch.launch.mesh.init_ranks):
    mesh = make_auto_mesh((world,), ("cols",))
    basis = build_basis(source=S, tau=1e-6, mesh=mesh)   # "distributed"
"""

from repro_torch.api.artifact import ReducedBasis
from repro_torch.api.basis_set import ReducedBasisSet
from repro_torch.api.build import (
    build_basis, build_basis_set, device_memory_budget,
)
from repro_torch.api.spec import STRATEGIES, ReductionSpec
from repro_torch.compat import make_auto_mesh

__all__ = ["ReductionSpec", "ReducedBasis", "ReducedBasisSet", "build_basis",
           "build_basis_set", "STRATEGIES", "device_memory_budget",
           "make_auto_mesh"]
