"""Command-line interface of the port: `guacamole-torch`.

Ports the seven commands of guacamole_tpu/cli.py (germline-threshold,
germline-standard, somatic-standard, variant-support, vaf-histogram,
structural-variant and index) onto the PyTorch device layer, with the same
flags and output. The device mesh and the multi-process runtime are not
ported yet: their flags are accepted and refused with a one-line error.
Every command that touches a device runs on the GPU unless --device cpu
asks for the CPU.

    python -m guacamole_tpu_torch.cli germline-threshold --reads x.bam --out x.vcf
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from guacamole_tpu_torch.utils.progress import DelayedMessages, progress
from guacamole_tpu_torch import __version__


def _add_base_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--debug", action="store_true", help="Print debug output")


def _add_loci_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--loci",
        default="",
        help="Loci at which to call variants. Either 'all' or "
        "contig:start-end,contig:start-end,...",
    )
    p.add_argument(
        "--loci-from-file",
        default="",
        help="Path to file giving loci at which to call variants.",
    )


def _add_reads_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--reads", required=True, help="Aligned reads (BAM/SAM)")
    _add_read_loading_args(p)


def _add_read_loading_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--no-sequence-dictionary",
        action="store_true",
        help="Get contigs and lengths from reads, not the sequence dictionary",
    )
    p.add_argument(
        "--bam-reader-api",
        default="best",
        choices=["best", "native", "samtools", "hadoopbam", "python"],
        help="BAM decoding backend: 'best'/'native' use the multithreaded "
        "C++ runtime when available; 'samtools'/'hadoopbam'/'python' use "
        "the pure-Python decoder",
    )
    p.add_argument(
        "--recompute-md-tags",
        action="store_true",
        help="Recompute MD tags from the reference fasta",
    )


def _add_tumor_normal_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tumor-reads", required=True, help="Aligned tumor reads")
    p.add_argument("--normal-reads", required=True, help="Aligned normal reads")
    _add_read_loading_args(p)


def _add_concordance_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--truth", default="", help="Truth VCF to compute concordance against"
    )
    p.add_argument(
        "--exclude-snv",
        action="store_true",
        help="Exclude SNV variants in comparison",
    )
    p.add_argument(
        "--exclude-indel",
        action="store_true",
        help="Exclude indel variants in comparison",
    )
    p.add_argument("--chr", default="", help="Chromosome to filter to")


def _print_concordance(args, records) -> None:
    from guacamole_tpu_torch.concordance import print_genotype_concordance

    print_genotype_concordance(
        records,
        args.truth,
        exclude_snvs=args.exclude_snv,
        exclude_indels=args.exclude_indel,
        chromosome=args.chr,
    )


def _add_output_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--out",
        default="",
        help="Variant output path (.vcf or .json). Default: print to stdout.",
    )
    p.add_argument(
        "--max-genotypes",
        type=int,
        default=0,
        help="Maximum number of genotypes to output (0 = all)",
    )
    # Accepted-but-inert, as in guacamole_tpu/cli.py.
    p.add_argument("--out-chunks", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument(
        "--fragment-length", type=int, default=10000, help=argparse.SUPPRESS
    )
    p.add_argument(
        "--vcf-header-compat",
        default="",
        choices=["", "adam016"],
        dest="vcf_header_compat",
        help="VCF header boilerplate: default or 'adam016'; record content "
        "is identical either way.",
    )


def _add_distributed_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--parallelism",
        type=int,
        default=0,
        help="Number of variant-calling shards (0 = number of devices)",
    )
    p.add_argument(
        "--partition-accuracy",
        type=int,
        default=250,
        help="Micro-partitions per task for depth-balanced loci partitioning "
        "(0 = partition uniformly)",
    )
    p.add_argument(
        "--tile-size",
        type=int,
        default=0,
        help="Loci per device tile (0 = auto: size tiles to a memory "
        "budget so a whole region screens in O(1) kernel launches)",
    )
    p.add_argument(
        "--mesh",
        default="auto",
        choices=["auto", "on", "off"],
        help="'auto' and 'off' screen on one device; 'on' (screens spread "
        "over all devices) is not yet ported.",
    )
    # Multi-process runs are not yet ported; the flags are accepted so a
    # run that asks for one fails with a clear error instead of a usage
    # message.
    p.add_argument("--coordinator", default="", help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--recover", action="store_true", help=argparse.SUPPRESS)
    p.add_argument(
        "--timeout", type=float, default=-1.0, dest="dcn_timeout",
        help=argparse.SUPPRESS,
    )


def _add_device_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="Where the screens run: 'cuda' (the default; fails when no "
        "CUDA device is present) or 'cpu'.",
    )


def _resolve_device(args):
    from guacamole_tpu_torch.platform import device

    return device(args.device)


def _refuse_unported(args) -> None:
    """One device, one process: refuse what would need the mesh or the
    multi-process runtime, which are not yet ported."""
    if args.mesh == "on":
        raise NotImplementedError("--mesh on is not yet ported")
    multi = (
        args.coordinator
        or args.num_processes > 1
        or args.process_id >= 0
        or args.recover
        or int(os.environ.get("GUAC_NUM_PROCESSES", "0") or 0) > 1
    )
    if multi:
        raise NotImplementedError(
            "multi-process runs (--coordinator/--num-processes/--process-id"
            "/--recover) are not yet ported"
        )


def _default_parallelism() -> int:
    import torch

    return max(1, torch.cuda.device_count())


def _partition(args, loci_set, *read_lists):
    from guacamole_tpu_torch.loci.partition import partition_loci_from_args

    return partition_loci_from_args(
        args.parallelism,
        args.partition_accuracy,
        loci_set,
        *read_lists,
        default_parallelism=_default_parallelism(),
    )


def _streaming_partitions(args, loci_set, path):
    """Loci partitions for the per-task .bai-pushdown streaming path:
    uniform with --partition-accuracy 0, else depth-balanced from the BAM
    index's byte-density histogram (no read decode). None when depth
    balancing needs an index that can't be built."""
    from guacamole_tpu_torch.loci.partition import (
        partition_loci_by_index_depth,
        partition_loci_uniformly,
    )

    tasks = args.parallelism
    if not tasks:
        # ~3 MB of compressed BAM per task: enough tasks that each task's
        # decode (on a background thread) overlaps the previous task's
        # pack and screens, and per-task memory stays flat as inputs grow.
        try:
            size = os.stat(path).st_size
        except OSError:
            size = 0
        tasks = max(
            _default_parallelism(), min(64, max(1, size // (3 << 20)))
        )
    if args.partition_accuracy == 0:
        return partition_loci_uniformly(tasks, loci_set)
    from guacamole_tpu_torch.callers.streaming import ensure_bam_index

    bai_path = ensure_bam_index(path)
    if bai_path is None:
        return None
    return partition_loci_by_index_depth(
        tasks, loci_set, args.partition_accuracy, path, bai_path
    )


def _streaming_eligible(args) -> bool:
    """The read-loading configurations the streaming path supports.
    GUAC_NO_STREAMING=1 forces the whole-file load path."""
    if os.environ.get("GUAC_NO_STREAMING", "") == "1":
        return False
    return (
        not args.no_sequence_dictionary
        and not args.recompute_md_tags
        and args.bam_reader_api in ("best", "native")
    )


def _try_streaming_threshold(args, loci_builder, reference, device):
    """Streaming germline-threshold (per-task BAM pushdown); None when the
    streaming path is unavailable."""
    from guacamole_tpu_torch.reads.read import InputFilters
    from guacamole_tpu_torch.callers.germline_threshold import (
        call_variants_streaming,
    )

    try:
        # Availability probing only: a non-BAM input (or malformed header)
        # falls back to the whole-file loader, which reports its own
        # errors properly.
        from guacamole_tpu_torch.gio.bam import BamFile

        dictionary = dict(BamFile(args.reads).references)
    except Exception:
        return None
    loci_set = loci_builder.result(dictionary)
    partitions = _streaming_partitions(args, loci_set, args.reads)
    if partitions is None:
        return None
    filters = InputFilters.create(
        overlaps_loci=loci_builder, non_duplicate=True, has_mdtag=True
    )
    return call_variants_streaming(
        args.reads,
        filters,
        partitions,
        threshold_percent=args.threshold,
        emit_ref=args.emit_ref,
        emit_no_call=args.emit_no_call,
        tile_size=args.tile_size,
        reference_genome=reference,
        device=device,
    )


def cmd_germline_threshold(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="guacamole-torch germline-threshold",
        description="call variants by thresholding read counts (toy example)",
    )
    _add_base_args(p)
    _add_loci_args(p)
    _add_reads_args(p)
    _add_output_args(p)
    _add_distributed_args(p)
    _add_device_args(p)
    p.add_argument(
        "--threshold",
        type=int,
        default=8,
        metavar="X",
        help="Make a call if at least X%% of reads support it. Default: 8",
    )
    p.add_argument(
        "--emit-ref", action="store_true", help="Output homozygous reference calls"
    )
    p.add_argument(
        "--emit-no-call", action="store_true", help="Output no-call calls"
    )
    p.add_argument("--reference-fasta", default=None, help="Reference FASTA")
    _add_concordance_args(p)
    args = p.parse_args(argv)
    _refuse_unported(args)

    from guacamole_tpu_torch.callers.common import (
        load_read_source,
        resolve_loci_builder,
        validate_output_path,
        write_variants,
    )
    from guacamole_tpu_torch.gio.fasta import ReferenceGenome
    from guacamole_tpu_torch.reads.read import InputFilters
    from guacamole_tpu_torch.callers.germline_threshold import call_variants

    device = _resolve_device(args)
    validate_output_path(args.out)
    loci_builder = resolve_loci_builder(args.loci, args.loci_from_file)
    reference = (
        ReferenceGenome.from_fasta(args.reference_fasta)
        if args.reference_fasta
        else None
    )
    calls = None
    contig_lengths = None
    if _streaming_eligible(args):
        # Partitioning needs only the header's contig lengths (uniform) or
        # the BAM index's byte-density histogram (depth-balanced), so each
        # task can decode just its own BAM byte ranges (.bai pushdown),
        # overlapping the next task's IO with device screens.
        calls = _try_streaming_threshold(args, loci_builder, reference, device)
        if calls is not None:
            from guacamole_tpu_torch.gio.bam import BamFile

            contig_lengths = dict(BamFile(args.reads).references)
    if calls is None:
        filters = InputFilters.create(
            overlaps_loci=loci_builder, non_duplicate=True, has_mdtag=True
        )
        source, contig_lengths = load_read_source(
            args.reads,
            filters,
            contig_lengths_from_dictionary=not args.no_sequence_dictionary,
            reference_genome=reference,
            recompute_mdtags=args.recompute_md_tags,
            use_native=args.bam_reader_api in ("best", "native"),
        )
        progress(
            "Loaded %d mapped non-duplicate MdTag-containing reads."
            % source.n
        )
        loci_set = loci_builder.result(contig_lengths)
        calls = call_variants(
            source,
            _partition(args, loci_set, source),
            threshold_percent=args.threshold,
            emit_ref=args.emit_ref,
            emit_no_call=args.emit_no_call,
            tile_size=args.tile_size,
            reference_genome=reference,
            device=device,
        )
    progress("Called %d genotypes." % len(calls))
    records = [c.to_vcf_record() for c in calls]
    write_variants(
        records,
        args.out,
        contig_lengths=contig_lengths,
        max_genotypes=args.max_genotypes,
        vcf_header_compat=args.vcf_header_compat,
    )
    if args.truth:
        _print_concordance(args, records)
    DelayedMessages.default.print()
    return 0


# What the callers that bring their own `main` take from this module.
ARG_HELPERS = {
    "base": _add_base_args,
    "loci": _add_loci_args,
    "reads": _add_reads_args,
    "tumor_normal": _add_tumor_normal_args,
    "output": _add_output_args,
    "distributed": _add_distributed_args,
    "device": _add_device_args,
    "concordance": _add_concordance_args,
    "read_config": _add_read_loading_args,
    "default_parallelism": _default_parallelism,
    "refuse_unported": _refuse_unported,
    "resolve_device": _resolve_device,
    "partition": _partition,
    "streaming_partitions": _streaming_partitions,
    "streaming_eligible": _streaming_eligible,
    "print_concordance": _print_concordance,
}


def cmd_germline_standard(argv: List[str]) -> int:
    from guacamole_tpu_torch.callers.germline_standard import main as run

    rc = run(argv, ARG_HELPERS)
    DelayedMessages.default.print()
    return rc


def cmd_somatic_standard(argv: List[str]) -> int:
    from guacamole_tpu_torch.callers.somatic_standard import main as run

    rc = run(argv, ARG_HELPERS)
    DelayedMessages.default.print()
    return rc


def cmd_variant_support(argv: List[str]) -> int:
    from guacamole_tpu_torch.callers.variant_support import main as run

    return run(argv, ARG_HELPERS)


def cmd_vaf_histogram(argv: List[str]) -> int:
    from guacamole_tpu_torch.callers.vaf_histogram import main as run

    return run(argv, ARG_HELPERS)


def cmd_structural_variant(argv: List[str]) -> int:
    from guacamole_tpu_torch.callers.structural_variant import main as run

    return run(argv, ARG_HELPERS)


def cmd_index(argv: List[str]) -> int:
    """Build a .bai index for a coordinate-sorted BAM (enables the
    BAM-index region pushdown in the loaders)."""
    p = argparse.ArgumentParser(
        prog="guacamole-torch index",
        description="build a .bai index for a coordinate-sorted BAM",
    )
    p.add_argument("bam", help="Coordinate-sorted BAM to index")
    p.add_argument(
        "--out", default="", help="Index path (default: <bam>.bai)"
    )
    args = p.parse_args(argv)
    from guacamole_tpu_torch.gio.bai import build_bam_index

    out = build_bam_index(args.bam, args.out or None)
    progress(f"Wrote index: {out}")
    return 0


COMMANDS = {
    "germline-threshold": (
        cmd_germline_threshold,
        "call variants by thresholding read counts (toy example)",
    ),
    "germline-standard": (
        cmd_germline_standard,
        "call variants using a simple quality-based probability",
    ),
    "somatic-standard": (
        cmd_somatic_standard,
        "call somatic variants using independent callers on tumor and normal",
    ),
    "variant-support": (
        cmd_variant_support,
        "Find number of reads that support each variant across BAMs",
    ),
    "vaf-histogram": (
        cmd_vaf_histogram,
        "Compute and cluster the variant allele frequencies",
    ),
    "structural-variant": (
        cmd_structural_variant,
        "Find structural variants, e.g. large deletions",
    ),
    "index": (
        cmd_index,
        "Build a .bai index for a coordinate-sorted BAM",
    ),
}


def main(argv: Optional[List[str]] = None) -> int:
    from guacamole_tpu_torch.platform import tune_allocator

    tune_allocator()
    argv = list(sys.argv[1:] if argv is None else argv)
    # GUAC_PROFILE_DIR: record a torch.profiler trace (host and, on a GPU,
    # device activity) of the whole command into that directory.
    profile_dir = os.environ.get("GUAC_PROFILE_DIR")
    if not profile_dir:
        return _dispatch(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        rc = _dispatch(argv)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    progress(f"Wrote profile trace to {path}")
    return rc


def _dispatch(argv: List[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print(
            f"guacamole-torch {__version__}: the PyTorch/CUDA port of "
            "guacamole-tpu."
        )
        print("Usage: guacamole-torch <command> [args]\n\nCommands:")
        for name, (_, description) in COMMANDS.items():
            print(f"  {name:20s} {description}")
        return 0 if argv else 1
    command = argv[0]
    if command not in COMMANDS:
        print(f"Unknown command: {command}", file=sys.stderr)
        print(f"Valid commands: {', '.join(COMMANDS)}", file=sys.stderr)
        return 1
    try:
        return COMMANDS[command][0](argv[1:])
    except BrokenPipeError:
        return 1  # e.g. `guacamole-torch ... | head`
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except Exception as exc:
        # One-line operational errors (bad paths, malformed inputs);
        # --debug (anywhere in argv) keeps the full traceback.
        if "--debug" in argv:
            raise
        print(
            f"guacamole-torch {command}: error: {type(exc).__name__}: {exc} "
            "(re-run with --debug for the full traceback)",
            file=sys.stderr,
        )
        return 1


if __name__ == "__main__":
    sys.exit(main())
