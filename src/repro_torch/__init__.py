"""PyTorch/CUDA port of `repro` (Local Thresholding on DHTs).

It holds the single-device superstep engine (majority, mean and L2
problems, Alg. 2 churn; `repro_torch.engine.make_engine("torch", ...)`)
with its delivery-wheel kernels and `majority_step`, and the training
substrate on RecurrentGemma-9B and SmolLM-135M (`repro_torch.launch.train`:
plain data-parallel training and the threshold-gated pod sync) with its
`threshold_gate`, `rglru_scan` and `flash_attention_fwd` kernels; the
sharding plan on DTensor meshes (`distributed.sharding`), its dry run on
meta tensors (`launch.dryrun`) and its H100 roofline (`analysis`). Every
kernel is written in CUDA C++ for Hopper (`repro_torch.kernels`). The
package imports torch and numpy only — never jax and nothing of
`repro`; kernels are built on first use.
"""
