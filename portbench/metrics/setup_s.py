"""Process start to the window's start: imports, CUDA start, kernel
loads (builds on a first run), the fields made and compressed, warm-up."""


def read(m):
    return m["setup_s"]
