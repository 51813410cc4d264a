"""The port's CUDA kernels: one `Kernel` per C entry point, each with its
launch count. Importing this package builds and loads nothing.

`mad.cu`'s one entry point serves four instantiations, each counted on
its own: g = 3 (`mad_horner`, the multi-bit PBS), g = 2 (the multi-bit
rotation inside circuit bootstrapping), g = 1 (the single-bit phase_rot
step), each forming its step's (phase - 1) factors from their halves, and
g = 0 (`freq_mad`, one key row with no phase). Those four are its k+1 = 2
instances; every other k+1 runs its per-plane instance of the same g,
counted as `mad_any_kp1_g<g>`. Its second entry point, `freq_mad_batched`,
is the g = 0 MAD under a batched row: each batch column reads its own
GGSW row from a buffer of GGSWs (the CMux of the conversion cycle and of
the circuit executors)."""

from .build import Kernel

# argspec: "p" a pointer or the stream (c_void_p), "i" a C int; then the
# device functions a launch runs (counts that share a function share one
# tuple: `scripts.time_calls` holds a profile's events of each tuple
# against the launches counted)
ACCUMULATE_DECOMPOSE = Kernel("rot_decomp", "spf_accumulate_decompose", "pppppiiip",
                              ("accumulate_decompose_kernel",))
_ROTATE = ("rotate_sub_decompose_kernel",)
ROTATE_SUB_DECOMPOSE = Kernel("rot_decomp", "spf_rotate_sub_decompose", "pppiiiiip", _ROTATE)
ROTATE_SUB_DECOMPOSE_ACC = Kernel("rot_decomp", "spf_rotate_sub_decompose_acc",
                                  "pppppp" + "iiiii" + "p", _ROTATE)
FWD_DS = Kernel("fft", "spf_fwd_ds", "ppppiiip", ("fwd_ds_kernel",))
INV_DS = Kernel("fft", "spf_inv_ds", "ppppppiiip", ("inv_ds_kernel",))
_MAD_ARGS = "p" * 20 + "iiiiii" + "p"
_MAD = ("mad_horner_kernel",)
MAD_HORNER = Kernel("mad", "spf_mad_horner", _MAD_ARGS, _MAD)
MAD_HORNER_G2 = Kernel("mad", "spf_mad_horner", _MAD_ARGS, _MAD)
MAD_HORNER_G1 = Kernel("mad", "spf_mad_horner", _MAD_ARGS, _MAD)
FREQ_MAD = Kernel("mad", "spf_mad_horner", _MAD_ARGS, _MAD)
MAD_BY_GROUP = {0: FREQ_MAD, 1: MAD_HORNER_G1, 2: MAD_HORNER_G2, 3: MAD_HORNER}
MAD_ANY_KP1_BY_GROUP = {g: Kernel("mad", "spf_mad_horner", _MAD_ARGS,
                                  ("mad_plane_kernel", "mad_planes_kernel"))
                        for g in range(4)}
FREQ_MAD_BATCHED = Kernel("mad", "spf_freq_mad_batched", "p" * 13 + "iiiii" + "qqq" + "p",
                          ("mad_batched_kernel",))
FENCE = Kernel("fence", "spf_fence", "ppip", ("copy_kernel",))
PHASE_MINUS_ONE = Kernel("phase", "spf_phase_minus_one", "p" * 10 + "iip", ("phase_kernel",))
# the probes of spf_tpu_torch.scripts.vpu_probe
CHAIN = Kernel("probe", "spf_chain", "ppiiip", ("chain_kernel",))
FMA_PROBE = Kernel("probe", "spf_fma_probe", "pppiiip", ("fma_probe_kernel",))
FMA_PROBE_FMA = Kernel("probe", "spf_fma_probe_fma", "pppiiip", ("fma_probe_fma_kernel",))
ROLL = Kernel("probe", "spf_roll", "ppiiiip", ("roll_kernel",))

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
    "freq_mad_batched": FREQ_MAD_BATCHED,
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
