"""PyTorch/CUDA port of layerskip_tpu (dense-Llama self-speculative decoding)."""
