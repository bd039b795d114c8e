"""Algorithm 3 (RB-greedy) and its primitives, ported to PyTorch."""
