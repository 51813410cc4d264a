"""The port's CUDA kernels: one `Kernel` per C entry point, each with its
launch count. Importing this package builds and loads nothing."""

from .build import Kernel

# argspec: "p" a pointer or the stream (c_void_p), "i" a C int
ACCUMULATE_DECOMPOSE = Kernel("rot_decomp", "spf_accumulate_decompose", "pppppiiip")
FWD_DS = Kernel("fft", "spf_fwd_ds", "pppppppiiip")
INV_DS = Kernel("fft", "spf_inv_ds", "pppppppiiip")
MAD_HORNER = Kernel("mad", "spf_mad_horner", "p" * 16 + "iiiiip")
FENCE = Kernel("fence", "spf_fence", "ppip")

ALL = {
    "accumulate_decompose": ACCUMULATE_DECOMPOSE,
    "fwd_ds": FWD_DS,
    "inv_ds": INV_DS,
    "mad_horner": MAD_HORNER,
    "fence": FENCE,
}


def reset_launches() -> None:
    for k in ALL.values():
        k.launches = 0


def launches() -> dict:
    return {name: k.launches for name, k in ALL.items()}
