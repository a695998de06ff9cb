"""sbeacon_tpu_torch — the Beacon query path on PyTorch and CUDA.

A port of ``sbeacon_tpu`` (JAX on a TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (H100, ``sm_90a``). The JAX package is
the reference this package is held against; this package imports
nothing of it and never imports JAX. Its entry points run on the GPU
unless the caller passes ``device="cpu"``, where each kernel runs its
plain-PyTorch twin.
"""

__version__ = "0.1.0"
