"""reforge-tpu on PyTorch and CUDA: the port of ``reforge_tpu`` to one
NVIDIA H100.

Module names follow ``reforge_tpu`` so each counterpart is easy to find.
Images are planar ``(C, H, W)`` tensors on an explicit device.  Plain
tensor code is PyTorch; every kernel the JAX package wrote in Pallas is a
hand-written CUDA kernel here (``csrc/``, bound in
``kernels/cuda_ops.py``), with a plain PyTorch version beside it that CPU
tensors run through.  Nothing here imports jax.
"""

__version__ = "0.1.0"
