"""PyTorch/CUDA port of photon_ml_tpu.

The JAX package ``photon_ml_tpu`` stays beside this one as the reference;
this package imports nothing of it (and never ``jax``). Its slice so far is
the dense GLM training path: losses, batches, normalization, the GLM
objective with hand-written CUDA kernels for the one-pass value+gradient
and Hessian-vector passes (``ops/fused.py``, ``csrc/fused_glm.cu``), the
L-BFGS / OWL-QN / TRON solvers, evaluators, ``train_glm`` and its CLI.

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""

from photon_ml_tpu_torch import _device  # noqa: F401  (float32 precision policy)
