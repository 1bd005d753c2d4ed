"""hifimeth_tpu_torch: the PyTorch/CUDA port of hifimeth-tpu.

Runs all-context read-level `call` on an NVIDIA GPU, with the per-site
window gather as a hand-written CUDA kernel (ops/csrc/group_windows.cu),
the host commands after it, and the model lifecycle (import-model,
export-model, extract-features, train).  Imports nothing of the JAX
package."""

__version__ = "0.1.0"
