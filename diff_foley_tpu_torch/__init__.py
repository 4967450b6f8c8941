"""PyTorch/CUDA port of diff_foley_tpu for NVIDIA Hopper (H100).

Same models, samplers and DSP as the JAX package, with the JAX package's
public shapes; its Pallas TPU kernels become hand-written CUDA kernels
(``csrc/``, built on first use by ``ops/cuda_build.py``). Entry points run
on the GPU unless the caller passes ``device="cpu"``.
"""
