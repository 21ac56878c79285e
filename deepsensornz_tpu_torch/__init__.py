"""PyTorch/CUDA port of the deepsensornz_tpu ConvNP downscaling stack.

The package mirrors ``deepsensornz_tpu``'s layout (``ops/``, ``models/``,
``task/``, ``data/``, ``infer/``, ``train/``) and never imports JAX, flax or
the JAX package. Importing it loads nothing heavy: the CUDA kernels under
``csrc/`` are compiled on first use (``ops/_build.py``).
"""

__version__ = "0.1.0"
