"""glue_device_share.uint (%): device time in the kernels that PyTorch's
operators launch (the CBS trace and scheme switch, the waves' gathers and
scatters, the limb arithmetic) over all device time. A kernel counts as
glue by its launcher, an `aten::` operator on the host, and never by its
name, so a new kernel of the program's own leaves the glue share."""

from tfhe_bench.readers import glue_share


def read(rec):
    return glue_share(rec)
