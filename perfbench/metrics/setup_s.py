"""Process start to the first timed campaign: imports, the device context,
the kernel's build or load, and the warm-up epoch (host clock)."""


def read(run):
    return run["setup_s"]
