"""PyTorch/CUDA port of `repro` (Local Thresholding on DHTs).

The first slice holds the single-device superstep engine on the majority
problem (`repro_torch.engine.make_engine("torch", ...)`) and its four
delivery-wheel kernels, written in CUDA C++ for Hopper
(`repro_torch.kernels`). The package imports torch and numpy only —
never jax and nothing of `repro`; kernels are built on first use.
"""
