"""PyTorch / CUDA port of UniVST for NVIDIA Hopper; the JAX package univst_tpu is its reference."""
