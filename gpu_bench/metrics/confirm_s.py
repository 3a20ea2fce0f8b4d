"""Host seconds a call spends in the callers' exact f64 confirm and
classification (call_tile, calls_from_tile_rows, somatic_calls_from_row_pairs
and their per-pileup fallbacks), less the dispatch waits inside them."""


def read(run):
    return run.layer_per_call("confirm")
