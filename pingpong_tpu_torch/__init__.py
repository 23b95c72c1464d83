"""pingpong_tpu_torch — the PyTorch / CUDA port of ``pingpong_tpu``.

The same two-player spin-physics Pong self-play trainer, written for one
NVIDIA H100: plain tensor code is PyTorch, and each Pallas kernel of the
JAX package on the training path is a hand-written CUDA kernel
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.
Every kernel keeps a plain PyTorch version beside it in the same module;
the wrapper runs that version only for tensors on the CPU (the tests) and
launches the kernel for tensors on the card.

The port imports nothing from the JAX package; the two share only the
npz + ``meta.json`` checkpoint schema, so a model trained by one loads
and plays in the other.
"""

__version__ = "0.1.0"
