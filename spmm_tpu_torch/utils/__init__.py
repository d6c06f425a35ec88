from spmm_tpu_torch.utils.serialize import load, save

__all__ = ["load", "save"]
