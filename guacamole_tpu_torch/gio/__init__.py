"""Genomic I/O: SAM/BAM/BAI/FASTA readers and VCF read/write.

(Package named 'gio' to avoid shadowing the stdlib 'io' module.)
"""

from guacamole_tpu_torch.gio.load import load_reads, load_read_set
