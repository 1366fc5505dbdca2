"""lighthouse2_tpu_torch — the PyTorch + CUDA port of lighthouse2_tpu.

The package mirrors the JAX package's layout (core/, scene/, bvh/, render/,
render/kernels/, diff/) so each module's counterpart sits at the same path. It
imports torch and numpy only; the JAX package is the reference its tests
hold it against. Entry points run on the first CUDA card unless the caller
passes device="cpu" (see device.py).
"""

__version__ = "0.1.0"

from lighthouse2_tpu_torch.api import RenderAPI  # noqa: F401,E402
