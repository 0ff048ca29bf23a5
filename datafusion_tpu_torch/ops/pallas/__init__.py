"""Hand-written Hopper (sm_90a) kernels, named and placed after the JAX
package's Pallas kernels they replace (datafusion_tpu/ops/pallas/). Each
module holds a kernel's wrapper, its launch count and its plain PyTorch
version; the CUDA sources live in datafusion_tpu_torch/csrc/."""
