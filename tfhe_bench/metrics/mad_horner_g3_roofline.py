"""mad_horner_g3_roofline (%): the multi-bit MAD of `csrc/mad.cu` `<2, 3>`,
its bound (bytes over the HBM rate or f32 instructions over the issue rate,
`frozen/roofline.py`) over its device time, summed over the traced launches."""

from tfhe_bench.readers import mad_roofline


def read(rec):
    return mad_roofline(rec, 3, "mad_horner_g3")
