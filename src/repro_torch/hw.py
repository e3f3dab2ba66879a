"""NVIDIA H100 hardware constants for the roofline cost model
(`core/costmodel.py`).

The port's own copy of `repro/hw.py`'s `ChipSpec`, with the same fields,
filled for the card the port runs on. The TPU spec and the TPU mesh shapes
are not carried over: the port states no number taken on or for a TPU.
Each value below is from NVIDIA's H100 SXM5 data sheet (dense rates, no
sparsity, at the full 700 W power limit); `chip_smoke.py` prints the card's
own memory size and shared-memory budget (`torch.cuda.get_device_properties`)
beside them. Three fields keep the reference's TPU names:
  ici_bw_per_link, ici_links  NVLink 4: 18 links of 25 GB/s each way
                              (900 GB/s to the other cards, 450 each way);
  vmem_bytes                  the shared memory one block can use (227 KiB
                              of the SM's 228 KiB), the kernels' tiling
                              budget in place of VMEM;
  mxu_tile                    wgmma's tile of 64 rows, in place of the MXU's
                              128 x 128.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    hbm_bytes: float            # HBM capacity per chip
    hbm_bw: float               # bytes/s HBM bandwidth per chip
    ici_bw_per_link: float      # bytes/s per chip-to-chip link, each way
    ici_links: int              # links per chip
    host_dma_bw: float          # bytes/s host<->HBM, each way
    vmem_bytes: float           # on-chip tiling budget of one kernel block
    mxu_tile: int               # rows of one matrix-unit tile


H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,     # dense bf16 on the tensor cores
    hbm_bytes=80e9,             # 80 GB HBM3
    hbm_bw=3.35e12,             # 3.35 TB/s
    ici_bw_per_link=25e9,       # NVLink 4, per link each way
    ici_links=18,
    host_dma_bw=64e9,           # PCIe Gen5 x16, 64 GB/s each way
    vmem_bytes=227 * 1024,      # 232,448 bytes of shared memory per block
    mxu_tile=64,                # wgmma M
)

DEFAULT_CHIP = H100_SXM
