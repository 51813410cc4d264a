"""mad_horner_g2_roofline (%): the circuit bootstrap's MAD of
`csrc/mad.cu` `<2, 2>`, each launch at its wave's width, bound over device
time summed over the traced launches."""

from tfhe_bench.readers import mad_roofline


def read(rec):
    return mad_roofline(rec, 2, "mad_horner_g2")
