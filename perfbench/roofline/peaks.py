"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W limit): the yardstick of every roofline share
and MFU. A run prints the card's power limit beside them."""

BF16_FLOPS = 989e12     # FLOP/s, bf16 tensor cores, dense
HBM_BYTES = 3.35e12     # B/s, HBM3
