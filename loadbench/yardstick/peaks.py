"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at its full 700 W power limit)."""

MEM_BYTES_PER_S = 3.35e12  # HBM3
BF16_FLOP_PER_S = 989e12  # tensor cores, bf16 and fp16
FP32_FLOP_PER_S = 67e12  # CUDA cores, no TF32
