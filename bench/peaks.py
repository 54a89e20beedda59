"""Published peaks of one NVIDIA H100 SXM at its 700 W limit, the yardstick
of every roofline and utilization metric.

Copied from ``src/repro_torch/core/hardware.py`` (``H100_SXM``: peak_flops,
hbm.bandwidth, host.bandwidth), so a change to the program cannot move it.
"""
BF16_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s (data sheet)
HBM_BYTES_S = 3.35e12        # HBM3 bytes/s
LINK_BYTES_S = 64e9          # PCIe 5.0 x16 host link bytes/s, one direction
