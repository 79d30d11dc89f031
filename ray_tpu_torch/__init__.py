"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's device layer.

The layout mirrors ``ray_tpu/`` so each module's counterpart is found under
the same path. Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas is a hand-written CUDA kernel under ``ops/kernels/csrc``,
built with nvcc at first use. The package imports torch and numpy only —
never jax, never ray_tpu.

Entry points take an explicit ``device`` and default to ``"cuda"``; on a
machine without CUDA they raise rather than fall back to the CPU.
"""

__all__ = ["models", "ops", "train", "bench", "bridge"]
