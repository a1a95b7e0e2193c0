"""PyTorch/CUDA port of horizonnet_tpu for NVIDIA Hopper GPUs.

The JAX package ``horizonnet_tpu`` is the reference this port is held to;
this package never imports it (nor jax or flax). Module paths mirror the
JAX package's. Tensors are NCHW and every entry point takes an explicit
``device``; a CUDA device that is missing is an error, never a CPU run.
"""
