"""qps: queries answered, with their results on the host, over the whole
window, from the first batch sent to the last answer."""


def read(rec):
    w = rec.window
    return (w.attempted - w.failed) / w.elapsed_s
