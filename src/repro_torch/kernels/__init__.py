"""Hand-written CUDA kernels of the port, each a package with ``ref.py``
(the plain PyTorch version, which the CPU takes and the card is held
against) and ``ops.py`` (the wrapper: checks, launch, launch counter):

- ``greedy_update`` — the Eq.-(6.3) pivot-search sweep
  (``csrc/greedy_update.cu``).
- ``imgs_project``  — one iterated-GS pass (``csrc/imgs_project.cu``).
"""
