from spmm_tpu_torch.utils.profiling import OpTime, Profile, profile_fn
from spmm_tpu_torch.utils.serialize import load, save
from spmm_tpu_torch.utils.timing import Timing, measure, measure_device_loop, measure_host

__all__ = ["load", "save", "Timing", "measure", "measure_device_loop", "measure_host",
           "OpTime", "Profile", "profile_fn"]
