"""PyTorch/CUDA port of pepper_tpu for NVIDIA Hopper (H100)."""
