from spmm_tpu_torch.preprocess.reorder import bitmap_reorder, dominant_sections
from spmm_tpu_torch.preprocess.regions import split_regions, region_distinct_counts
from spmm_tpu_torch.preprocess.panels import panelize, panel_sort
from spmm_tpu_torch.preprocess.pipeline import preprocess, unpack_to_csr

__all__ = [
    "bitmap_reorder",
    "dominant_sections",
    "split_regions",
    "region_distinct_counts",
    "panelize",
    "panel_sort",
    "preprocess",
    "unpack_to_csr",
]
