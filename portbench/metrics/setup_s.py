"""Process start to the first timed call: imports, the kernel build on a
checkout's first run, loading, warm-up."""


def read(rec):
    return rec["setup_s"]
