"""Core model-reduction algorithms from the paper, ported to PyTorch.

The recommended entry point is the front door, :mod:`repro_torch.api` —
``build_basis(source=S, tau=...)`` dispatches to the right engine
(``strategy="pod" | "mgs" | "greedy" | "block_greedy" | "streamed" |
"distributed" | "randomized" | "sketch+greedy" | "auto"``) and returns one
``ReducedBasis`` artifact (``"batched"``: a ``ReducedBasisSet``).

- :mod:`repro_torch.core.pod`            -- Algorithm 1 (POD via SVD).
- :mod:`repro_torch.core.mgs`            -- Algorithm 2 (MGS with column
  pivoting; direct ``mgs_pivoted_qr`` calls are deprecated in favor of the
  front door — the implementation stays as the Prop.-5.3 reference).
- :mod:`repro_torch.core.greedy`         -- Algorithm 3 (RB-greedy with
  Hoffmann IMGS; the chunked, stepwise and fixed-length drivers).
- :mod:`repro_torch.core.block_greedy`   -- blocked variant (p pivots per
  sweep).
- :mod:`repro_torch.core.batch_greedy`   -- B greedy builds in lockstep
  (``strategy="batched"``), stacked or over one shared S, each lane bitwise
  the scalar driver.
- :mod:`repro_torch.core.distributed`    -- the paper's Sec. 6 system: S
  split by column over the ranks of a ``torch.distributed`` mesh, the
  pivot exchanged with collectives (``strategy="distributed"``).
- :mod:`repro_torch.core.streaming`      -- the out-of-core driver: S
  streamed through the device in column tiles from a snapshot provider.
- :mod:`repro_torch.core.randomized`     -- streamed randomized
  range-finder (sketched POD): ONE pass over the provider builds
  Y = S @ Omega, then a small dense SVD; ``estimate_rank``.
- :mod:`repro_torch.core.rrqr`           -- optimal RRQR (Theorem 5.1).
- :mod:`repro_torch.core.reconstruction` -- Algorithm 4 (QR + SVD-of-R).
- :mod:`repro_torch.core.eim`            -- empirical interpolation + ROQ.
- :mod:`repro_torch.core.errors`         -- the paper's error identities.
- :mod:`repro_torch.core.backend`        -- hot-loop primitive dispatch
  (the hand-written CUDA kernels, or their plain versions on the CPU).
"""

from repro_torch.core.backend import (
    default_backend,
    resolve_backend,
    set_default_backend,
)
from repro_torch.core.batch_greedy import BatchGreedyResult, batch_rb_greedy
from repro_torch.core.distributed import (
    DistGreedyState,
    dist_greedy_init,
    distributed_greedy,
)
from repro_torch.core.eim import eim_nodes, empirical_interpolant, roq_weights
from repro_torch.core.greedy import (
    GreedyResult,
    imgs_orthogonalize,
    rb_greedy,
    rb_greedy_scan,
    rb_greedy_stepwise,
)
from repro_torch.core.mgs import mgs_pivoted_qr
from repro_torch.core.pod import pod, pod_basis
from repro_torch.core.randomized import (
    RandomizedSketchResult,
    RankEstimate,
    estimate_rank,
    rb_randomized_streamed,
)
from repro_torch.core.reconstruction import reconstruction
from repro_torch.core.rrqr import optimal_rrqr
from repro_torch.core.streaming import StreamedGreedyResult, rb_greedy_streamed

__all__ = [
    "pod", "pod_basis", "mgs_pivoted_qr", "GreedyResult", "rb_greedy",
    "rb_greedy_stepwise", "rb_greedy_scan", "imgs_orthogonalize",
    "optimal_rrqr", "reconstruction", "eim_nodes", "empirical_interpolant",
    "roq_weights", "resolve_backend", "StreamedGreedyResult",
    "rb_greedy_streamed", "rb_randomized_streamed",
    "RandomizedSketchResult", "estimate_rank", "RankEstimate",
    "batch_rb_greedy", "BatchGreedyResult", "distributed_greedy",
    "DistGreedyState", "dist_greedy_init", "default_backend",
    "set_default_backend",
]
