"""setup_s (s): process start to the window's start: imports, CUDA, the
kernel build (cached after a checkout's first run), keygen, the server's key
conversion and schedule, one warm-up call."""


def read(rec):
    return rec.get("setup_s")
