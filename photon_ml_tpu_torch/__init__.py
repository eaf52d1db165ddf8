"""PyTorch/CUDA port of photon_ml_tpu.

The JAX package ``photon_ml_tpu`` stays beside this one as the reference;
this package imports nothing of it (and never ``jax``). Its slices so far:
the dense GLM training path (losses, batches, normalization, the GLM
objective with hand-written CUDA kernels for the one-pass value+gradient
and Hessian-vector passes, ``ops/fused.py`` and ``csrc/fused_glm.cu``, the
L-BFGS / OWL-QN / TRON solvers, evaluators, ``train_glm`` and its CLI);
the high-dimensional sparse path (``ops/sparse_tiled.py``,
``csrc/sparse_tiled.cu``); GAME mixed-effect training in memory
(``game/``, ``estimators.py``, ``transformers.py``, damped Newton over
entity lanes in ``optim/newton.py``); and the GAME train and score drivers
on Avro files (``io/``, ``checkpoint.py``, ``cli/train.py``,
``cli/score.py``).

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""

from photon_ml_tpu_torch import _device  # noqa: F401  (float32 precision policy)
