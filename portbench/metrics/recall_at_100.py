"""recall_at_100: the share of the window's answers whose exact nearest
neighbour (the benchmark's own ground truth) is among the 100 returned
(t = 1, as the reference's recall.hpp)."""

from portbench.reference.search import recall_at_r


def read(rec):
    if rec.labels is None or not len(rec.labels):
        return None
    return recall_at_r(rec.labels, rec.dep.truth.cpu().numpy()[rec.window.qids])
