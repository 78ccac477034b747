"""tpu3drec_torch — the PyTorch/CUDA port of tpu3drec.

Mirrors the JAX package file for file (`tpu3drec_torch/sfm/icp.py` ports
`tpu3drec/sfm/icp.py`). It imports `torch`, never `jax` and nothing of
`tpu3drec`. Every Pallas TPU kernel on a ported path has a hand-written
CUDA kernel under `ops/csrc/`, bound with ctypes, beside a plain PyTorch
version of the same function that runs on the CPU.
"""
