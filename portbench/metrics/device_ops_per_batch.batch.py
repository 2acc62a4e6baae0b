"""device_ops_per_batch.batch: device ops (kernels, copies, sets) the
profiler recorded in the traced window, over the batches searched in it."""


def read(rec):
    batches = rec.window.batches
    if not rec.events or not batches:
        return None
    return len(rec.events) / len(batches)
