"""setup_s: from the process's start to the first timed call (host clock):
imports, the CUDA context, loading (or, in a fresh checkout, building)
the program's library, the table, the inputs and the warm-up of the
cell's own shapes."""


def read(rec):
    return rec.setup_s
