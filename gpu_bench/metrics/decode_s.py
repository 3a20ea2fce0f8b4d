"""Host seconds a call spends in the streaming decode (BGZF inflate, BAM
parse, read filters; runtime/columnar.py, runtime/native.py), summed over
the threads that run it."""


def read(run):
    return run.layer_per_call("decode")
