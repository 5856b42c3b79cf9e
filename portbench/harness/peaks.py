"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit): the yardstick of every
roofline and MFU reading."""

BF16_FLOPS = 989e12        # bf16 / fp16 on the tensor cores
F32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
# base-2 exponentials (ex2) on the special function units: 16 a clock an SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) × 132 SMs × 1.98 GHz, the H100 SXM's boost clock
SFU_EXP2_PER_S = 132 * 16 * 1.98e9
