"""Hand-written CUDA kernels of the port, each a package with ``ref.py``
(the plain PyTorch version, which the CPU takes and the card is held
against) and ``ops.py`` (the wrapper: checks, launch, launch counter):

- ``greedy_update`` — the Eq.-(6.3) pivot-search sweep
  (``csrc/greedy_update_lanes_sm90.cu`` with one lane,
  ``csrc/greedy_update.cu``).
- ``greedy_update_lanes`` — B lanes of that sweep in one launch, one read
  of a shared S for up to 16 lanes (``csrc/greedy_update_lanes_sm90.cu``).
- ``imgs_project``  — one iterated-GS pass (``csrc/imgs_project_sm90.cu``,
  ``csrc/imgs_project.cu``).
- ``block_sweep``   — the blocked Eq.-(6.3) sweep, p bases per read of S
  (``csrc/block_sweep.cu``).
- ``imgs_panel``    — one iterated-GS pass on a panel of p candidates
  (``csrc/imgs_panel.cu``).
- ``flash_attention`` — causal / sliding-window GQA attention of the LM
  prefill (``csrc/flash_attention.cu``).
- ``roq_apply``     — the ROQ serving interpolant apply ``B @ F``, each
  column's bits independent of the batch width (``csrc/roq_apply.cu``).
- ``taylorf2``      — TaylorF2 waveform tiles for the streamed build and the
  resident S, each column's bits independent of the tile
  (``csrc/taylorf2.cu``).
- ``sketch_omega``  — the randomized range-finder's test blocks, JAX's
  Threefry-2x32 stream (``csrc/sketch_omega.cu``).
- ``column_norms``  — fixed-order squared column norms, the bits of the
  plain halving tree in one read (``csrc/column_norms.cu``).
- ``llc_probe``     — ``reps`` reads of a working set in one launch, the
  roofline model's cache measurement (``csrc/llc_probe.cu``).
"""
