"""Host seconds a call spends packing tiles (pack/columnar.py,
pack/tiles.py, runtime/native.py's packer), summed over threads."""


def read(run):
    return run.layer_per_call("pack")
