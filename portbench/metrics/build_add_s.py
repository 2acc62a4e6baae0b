"""build_add_s: seconds of set-up's `add` stage (deploy.build's
`stages`, host clock, the device synchronised at its end): the index built
from the drawn base by the program (assignment, encoding and the scatter
into partitions, chunk by chunk, then the padding and the copy to the
device). A part of setup_s. None without that stage."""


def read(rec):
    return rec.dep.stages.get("add")
