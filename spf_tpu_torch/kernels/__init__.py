"""The port's CUDA kernels: one `Kernel` per C entry point, each with its
launch count. Importing this package builds and loads nothing.

`mad.cu`'s one entry point serves four instantiations, each counted on
its own: g = 3 (`mad_horner`, the multi-bit PBS), g = 2 (the multi-bit
rotation inside circuit bootstrapping), g = 1 (the single-bit phase_rot
step), each forming its step's (phase - 1) factors from their halves, and
g = 0 (`freq_mad`, one key row with no phase). Those four are its k+1 = 2
instances; every other k+1 runs its per-plane instance of the same g,
counted as `mad_any_kp1_g<g>`."""

from .build import Kernel

# argspec: "p" a pointer or the stream (c_void_p), "i" a C int
ACCUMULATE_DECOMPOSE = Kernel("rot_decomp", "spf_accumulate_decompose", "pppppiiip")
ROTATE_SUB_DECOMPOSE = Kernel("rot_decomp", "spf_rotate_sub_decompose", "pppiiiiip")
ROTATE_SUB_DECOMPOSE_ACC = Kernel("rot_decomp", "spf_rotate_sub_decompose_acc",
                                  "pppppp" + "iiiii" + "p")
FWD_DS = Kernel("fft", "spf_fwd_ds", "ppppiiip")
INV_DS = Kernel("fft", "spf_inv_ds", "ppppppiiip")
_MAD_ARGS = "p" * 20 + "iiiiii" + "p"
MAD_HORNER = Kernel("mad", "spf_mad_horner", _MAD_ARGS)
MAD_HORNER_G2 = Kernel("mad", "spf_mad_horner", _MAD_ARGS)
MAD_HORNER_G1 = Kernel("mad", "spf_mad_horner", _MAD_ARGS)
FREQ_MAD = Kernel("mad", "spf_mad_horner", _MAD_ARGS)
MAD_BY_GROUP = {0: FREQ_MAD, 1: MAD_HORNER_G1, 2: MAD_HORNER_G2, 3: MAD_HORNER}
MAD_ANY_KP1_BY_GROUP = {g: Kernel("mad", "spf_mad_horner", _MAD_ARGS) for g in range(4)}
FENCE = Kernel("fence", "spf_fence", "ppip")
PHASE_MINUS_ONE = Kernel("phase", "spf_phase_minus_one", "p" * 10 + "iip")
# the probes of spf_tpu_torch.scripts.vpu_probe
CHAIN = Kernel("probe", "spf_chain", "ppiiip")
FMA_PROBE = Kernel("probe", "spf_fma_probe", "pppip")
FMA_PROBE_FMA = Kernel("probe", "spf_fma_probe_fma", "pppip")
ROLL = Kernel("probe", "spf_roll", "ppiiiip")

ALL = {
    "accumulate_decompose": ACCUMULATE_DECOMPOSE,
    "rotate_sub_decompose": ROTATE_SUB_DECOMPOSE,
    "rotate_sub_decompose_acc": ROTATE_SUB_DECOMPOSE_ACC,
    "fwd_ds": FWD_DS,
    "inv_ds": INV_DS,
    "mad_horner": MAD_HORNER,
    "mad_horner_g2": MAD_HORNER_G2,
    "mad_horner_g1": MAD_HORNER_G1,
    "freq_mad": FREQ_MAD,
    **{f"mad_any_kp1_g{g}": k for g, k in MAD_ANY_KP1_BY_GROUP.items()},
    "fence": FENCE,
    "phase_minus_one": PHASE_MINUS_ONE,
    "chain": CHAIN,
    "fma_probe": FMA_PROBE,
    "fma_probe_fma": FMA_PROBE_FMA,
    "roll": ROLL,
}


def reset_launches() -> None:
    for k in ALL.values():
        k.launches = 0


def launches() -> dict:
    return {name: k.launches for name, k in ALL.items()}
