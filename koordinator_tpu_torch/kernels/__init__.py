"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

- ``select_candidates`` (K1): fused Filter + Score + stratified top-k;
- ``round_fit_choose`` (K3a): a round's candidate fit and choice;
- ``prefix_accept`` (K3b): segmented priority-order prefix acceptance.

A wrapper handed CPU tensors computes its plain version; handed CUDA tensors
it launches its kernel (built on first use by :mod:`.build`) or raises.
"""
