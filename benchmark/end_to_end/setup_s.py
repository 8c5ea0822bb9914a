"""Seconds from the process's start to the window's start: imports, the
instances, the kernels' libraries, the warm-up solve or the root batch."""


def read(run):
    return run["setup_s"]
