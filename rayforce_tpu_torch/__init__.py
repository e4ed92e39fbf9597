"""rayforce-tpu's PyTorch/CUDA port: a columnar query engine with the
Rayfall language (capabilities of RayforceDB/rayforce) whose device
query engine runs on an NVIDIA GPU through PyTorch and hand-written CUDA
kernels. The JAX package `rayforce_tpu` is the reference it is held
against; this package imports nothing of it."""

from .core.builtins import Runtime  # noqa: F401,E402

__version__ = "0.1.0"
