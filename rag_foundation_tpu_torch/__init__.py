"""rag_foundation_tpu_torch — the engine of ``rag_foundation_tpu`` on
PyTorch and CUDA.

A port of the JAX package's serving path to an NVIDIA H100: the same
modules under the same names (``ops/``, ``engine/``, ``models/``,
``utils/``), plain tensor code in PyTorch, and a hand-written Hopper
kernel (``csrc/``) wherever the JAX package wrote a Pallas kernel. It
imports neither JAX nor the JAX package. Entry points run on the card
unless the caller asks for the CPU (``EngineConfig(device="cpu")``).
"""

__version__ = "0.1.0"
