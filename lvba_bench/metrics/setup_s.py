"""setup_s: process start to the window's start (s): imports, CUDA
init, the scene, the map and its upload, the starts, two warm-up solves
(the first run in a checkout builds the kernels there)."""


def read(rec):
    return rec["setup_s"]
