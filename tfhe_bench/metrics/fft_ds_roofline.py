"""fft_ds_roofline (%): both ds32 FFTs of `csrc/fft.cu` (`fwd_ds` on the
l(k+1) digit planes, `inv_ds` on the k+1 product planes), bounds over
device time summed over the traced launches."""

from tfhe_bench.frozen import roofline as rf
from tfhe_bench.readers import launches, roofline


def read(rec):
    shapes = rec.get("shapes", {})
    if "fwd_ds" not in shapes or "inv_ds" not in shapes:
        return None
    fwd = launches(rec, "fwd_ds_kernel")
    inv = launches(rec, "inv_ds_kernel")
    if not fwd or not inv:
        return None
    bound = (len(fwd) * rf.fft_bound_s(**shapes["fwd_ds"])
             + len(inv) * rf.fft_bound_s(**shapes["inv_ds"]))
    return roofline(bound, fwd + inv)
