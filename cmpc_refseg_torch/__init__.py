"""cmpc_refseg_torch — the PyTorch / CUDA port of the JAX package
(the TPU reference beside it in the repository).

Runs the CMPC referring-segmentation forward on an NVIDIA Hopper GPU with
hand-written CUDA kernels for the TPU package's Pallas kernels.  Imports
torch, never jax, and nothing of the JAX package.
"""
