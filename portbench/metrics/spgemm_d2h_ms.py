"""Device time of the device-to-host copies per call (the copy of C to the
host, ``ops.slab_spgemm._csr_to_host``, and any other)."""


def read(trace, counts):
    d2h = trace.seconds(lambda kind, name: kind == "gpu_memcpy" and "DtoH" in name)
    if not trace.calls or d2h <= 0:
        return None
    return 1e3 * d2h / trace.calls
