"""mad_batched_roofline (%): the batched-row MAD of `csrc/mad.cu`
(`mad_batched_kernel`, the CMux's, external product's and refresh's
product), the summed bound of every traced launch (`mad_batched_bound.py`:
distinct GGSW rows, digit spectra, outputs) over its summed device time.
The launches of a call are the system's `shapes()["mad_batched"]`
(one [B, distinct rows] a launch); None where the traced launches do not
come to that many a call."""

from tfhe_bench.mad_batched_bound import mad_batched_bound_s
from tfhe_bench.readers import launches, roofline


def read(rec):
    shape = rec.get("shapes", {}).get("mad_batched")
    times = launches(rec, "mad_batched_kernel")
    if shape is None or not times or not rec.get("calls"):
        return None
    per_call = shape["launches"]
    if len(times) != rec["calls"] * len(per_call):
        return None
    bound = sum(mad_batched_bound_s(shape["kp1"], shape["l"], shape["k"], b, d)
                for b, d in per_call)
    return roofline(rec["calls"] * bound, times)
