from spmm_tpu_torch.preprocess.reorder import (
    bitmap_perm_device,
    bitmap_reorder,
    dominant_sections,
    dominant_sections_device,
)
from spmm_tpu_torch.preprocess.regions import split_regions, region_distinct_counts
from spmm_tpu_torch.preprocess.panels import panelize, panel_sort
from spmm_tpu_torch.preprocess.pipeline import preprocess, unpack_to_csr

__all__ = [
    "bitmap_reorder",
    "dominant_sections",
    "bitmap_perm_device",
    "dominant_sections_device",
    "split_regions",
    "region_distinct_counts",
    "panelize",
    "panel_sort",
    "preprocess",
    "unpack_to_csr",
]
