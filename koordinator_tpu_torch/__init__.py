"""PyTorch/CUDA port of ``koordinator_tpu``.

The package mirrors the JAX package's module paths
(``koordinator_tpu/ops/scoring.py`` -> ``koordinator_tpu_torch/ops/scoring.py``)
and is held bit-for-bit against it by the ``tests/test_torch_*.py`` suites.
It imports ``torch`` and ``numpy`` only: never ``jax``, ``flax`` or any module
of ``koordinator_tpu``.

Entry points that create tensors take ``device=``; left unset they run on
``cuda`` and raise when no GPU is present (:func:`resolve_device`).  The hot
path of one batched scheduling round runs through hand-written CUDA kernels
(``koordinator_tpu_torch/kernels``); each kernel's wrapper takes its plain
PyTorch version when handed CPU tensors.
"""

from koordinator_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
