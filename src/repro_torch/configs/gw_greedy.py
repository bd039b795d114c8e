"""The paper's own production workload (Sec. 6.1.4, Blue Waters).

Column-pivoted QR via RB-greedy on a dense complex snapshot matrix:
N = 10,000 rows x M = 3,276,800 columns (~0.5 TB at complex64), k = 100
basis vectors — the largest matrix the paper reports (32,768 cores).
The port's copy of :mod:`repro.configs.gw_greedy` (data only); it sizes
:mod:`repro_torch.launch.reduce`.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class GreedyWorkload:
    name: str = "gw-greedy-bluewaters"
    n_rows: int = 10_000
    n_cols: int = 3_276_800
    dtype: str = "complex64"
    max_k: int = 100
    tau: float = 1e-12


CONFIG = GreedyWorkload()


def reduced():
    return GreedyWorkload(
        name="gw-greedy-small", n_rows=256, n_cols=2048, max_k=40, tau=1e-5
    )
