"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's H100 Tensor Core
GPU datasheet, at the full 700 W power limit).  The sparse products here are
bound by bytes, so the memory rate is the one peak the readers use."""

#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
