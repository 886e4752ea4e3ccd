"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

- ``select_candidates`` (K1): fused Filter + Score + stratified top-k;
- ``refresh_candidates`` (K2): the incremental candidate cache's refresh
  over the dirty node columns;
- ``round_fit_choose`` (K3a): a round's candidate fit and choice;
- ``prefix_accept`` (K3b): segmented priority-order prefix acceptance;
- ``greedy_scan`` (K4): the exact sequential greedy scan, and K4r, the
  same scan with reservations (the scheduler's reservation pre-pass);
- ``preemption`` (K5): the preemption chain's victim dry runs, node choice
  and commits; ``overuse_revoke`` (K6): the quota overuse revoke's walks;
- ``explain_counts`` (K7): the Diagnose phase's reject-reason count;
- ``offer_slots`` (K8): the gang offer-slot count of network-topology gang
  placement.

The Filter + Score of a (pod, node) pair and the candidate ranking are one
CUDA definition (``csrc/koord_score.cuh``) that K1, K2, K4, K4r and K7
compile.

A wrapper handed CPU tensors computes its plain version; handed CUDA tensors
it launches its kernel (built on first use by :mod:`.build`) or raises.
"""
