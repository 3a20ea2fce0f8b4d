from guacamole_tpu_torch.runtime.columnar import (
    ColumnarReads,
    columnar_from_reads,
    decode_bam_columnar,
    decode_sam_columnar,
    native_available,
)
