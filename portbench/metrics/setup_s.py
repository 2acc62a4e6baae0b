"""setup_s: from the process's start to the window's: imports, the device
draw, the ground truth, training, the build, the kernels' build or load,
and the warm-up of the cell's shapes."""


def read(rec):
    return rec.setup_s
