"""Deterministic read simulator for production-scale benchmarks.

The reference ships only tiny fixtures (chrM 16.5 kb; ~2k-read chr20
pairs), so depth- and length-scaling behavior is unmeasurable from its
test data. This module synthesizes coordinate-sorted SAM files with known
planted truth at arbitrary depth/contig-length:

  * a reference contig of random bases (seeded PCG64 — same seed, same
    bytes, so bench fixtures are reproducible across runs/machines),
  * planted germline het SNVs/insertions/deletions (two haplotypes),
  * optional somatic SNVs applied per-read at a given VAF (tumor samples),
  * uniform coverage bands (e.g. 25x background + a 1000x band + a
    10,000x spike) to drive the depth-bucketing / overflow paths,
  * a clump of many distinct insertion alleles at chosen loci to force
    >K distinct alleles (allele-dictionary overflow -> exact host path),
  * sequencing errors at a per-base rate, MD tags consistent with the
    planted reference (MD is the callers' reference source — no FASTA
    needed, matching the production MD-tag path).

Reads are generated vectorized (numpy gathers build the [N, read_len]
base matrix; only reads with mismatches or indels touch Python), so
multi-million-read fixtures generate in tens of seconds.

The planted truth (variant positions/alleles per contig) is returned so
benchmarks can gate performance numbers on recall/precision instead of
golden files (which would be impractically large at this scale).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
READ_LEN = 100
QUAL_CHAR = "I"  # phred 40


@dataclass
class PlantedVariants:
    """Truth set for one contig."""

    snv_pos: np.ndarray  # [n] int64 0-based positions (het, hap1)
    snv_alt: np.ndarray  # [n] uint8 alt base ascii
    ins_pos: np.ndarray  # [m] int64 anchor positions (insertion after)
    ins_seq: List[bytes]  # [m] inserted bases
    del_pos: np.ndarray  # [k] int64 first deleted position
    del_len: np.ndarray  # [k] int64
    somatic_pos: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int64)
    )
    somatic_alt: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.uint8)
    )

    def to_json(self) -> dict:
        return {
            "snv_pos": self.snv_pos.tolist(),
            "snv_alt": [chr(b) for b in self.snv_alt],
            "ins_pos": self.ins_pos.tolist(),
            "ins_seq": [s.decode() for s in self.ins_seq],
            "del_pos": self.del_pos.tolist(),
            "del_len": self.del_len.tolist(),
            "somatic_pos": self.somatic_pos.tolist(),
            "somatic_alt": [chr(b) for b in self.somatic_alt],
        }


def simulate_reference(rng: np.random.Generator, length: int) -> np.ndarray:
    """Random reference contig as an ascii uint8 array."""
    return BASES[rng.integers(0, 4, size=length)]


def plant_germline_variants(
    rng: np.random.Generator,
    ref: np.ndarray,
    snv_spacing: int = 1500,
    indel_spacing: int = 25000,
) -> PlantedVariants:
    """Het variants on haplotype 1: SNVs every ~snv_spacing bp, 1-3 bp
    insertions/deletions every ~indel_spacing bp. Indels are spaced at
    least 2*READ_LEN apart (and from contig ends) so any read spans at
    most one indel."""
    length = len(ref)
    snv_pos = np.arange(snv_spacing, length - snv_spacing, snv_spacing)
    snv_pos = snv_pos + rng.integers(
        -snv_spacing // 3, snv_spacing // 3, size=len(snv_pos)
    )
    snv_pos = np.unique(snv_pos[(snv_pos > READ_LEN) & (snv_pos < length - READ_LEN)])
    # alt = ref shifted by 1..3 in base order (never equal to ref)
    ref_idx = np.searchsorted(BASES, ref[snv_pos])
    snv_alt = BASES[(ref_idx + rng.integers(1, 4, size=len(snv_pos))) % 4]

    indel_anchor = np.arange(
        indel_spacing, length - indel_spacing, indel_spacing
    )
    indel_anchor = indel_anchor + rng.integers(
        -indel_spacing // 4, indel_spacing // 4, size=len(indel_anchor)
    )
    indel_anchor = np.unique(
        indel_anchor[
            (indel_anchor > 2 * READ_LEN)
            & (indel_anchor < length - 2 * READ_LEN)
        ]
    )
    # avoid SNV collisions within a read length
    near_snv = np.zeros(len(indel_anchor), dtype=bool)
    if len(snv_pos):
        j = np.searchsorted(snv_pos, indel_anchor)
        for off in (-1, 0):
            k = np.clip(j + off, 0, len(snv_pos) - 1)
            near_snv |= np.abs(snv_pos[k] - indel_anchor) < READ_LEN
    indel_anchor = indel_anchor[~near_snv]
    is_ins = rng.random(len(indel_anchor)) < 0.5
    lens = rng.integers(1, 4, size=len(indel_anchor))
    ins_pos = indel_anchor[is_ins]
    ins_seq = [
        bytes(BASES[rng.integers(0, 4, size=int(l))]) for l in lens[is_ins]
    ]
    del_pos = indel_anchor[~is_ins]
    del_len = lens[~is_ins].astype(np.int64)
    return PlantedVariants(
        snv_pos=snv_pos.astype(np.int64),
        snv_alt=snv_alt,
        ins_pos=ins_pos.astype(np.int64),
        ins_seq=ins_seq,
        del_pos=del_pos,
        del_len=del_len,
    )


def plant_somatic_snvs(
    rng: np.random.Generator,
    ref: np.ndarray,
    planted: PlantedVariants,
    region: Tuple[int, int],
    count: int,
) -> None:
    """Add somatic SNV sites inside region, away from germline variants."""
    lo, hi = region
    pos = np.sort(
        rng.choice(np.arange(lo + READ_LEN, hi - READ_LEN), count, replace=False)
    )
    germline = np.sort(
        np.concatenate([planted.snv_pos, planted.ins_pos, planted.del_pos])
    )
    if len(germline):
        j = np.searchsorted(germline, pos)
        ok = np.ones(len(pos), dtype=bool)
        for off in (-1, 0):
            k = np.clip(j + off, 0, len(germline) - 1)
            ok &= np.abs(germline[k] - pos) >= READ_LEN
        pos = pos[ok]
    ref_idx = np.searchsorted(BASES, ref[pos])
    planted.somatic_pos = pos.astype(np.int64)
    planted.somatic_alt = BASES[(ref_idx + 1) % 4]


def _hap1_sequence(ref: np.ndarray, planted: PlantedVariants) -> np.ndarray:
    """Haplotype-1 template with SNVs applied IN PLACE of ref bases (same
    coordinates; indels are handled per-read, not in the template)."""
    hap = ref.copy()
    hap[planted.snv_pos] = planted.snv_alt
    return hap


def _md_from_mismatches(offs: np.ndarray, refb: bytes) -> str:
    """MD:Z for an all-match read of READ_LEN with mismatches at offs
    (read offsets, sorted); refb[i] = reference base at offs[i]."""
    parts = []
    prev = 0
    for i, off in enumerate(offs):
        parts.append(str(off - prev))
        parts.append(chr(refb[i]))
        prev = off + 1
    parts.append(str(READ_LEN - prev))
    return "".join(parts)


@dataclass
class SimulatedReads:
    """Columnar reads for one contig, ready for SAM emission."""

    starts: np.ndarray  # [N] int64 0-based
    seqs: List[bytes]  # [N]
    cigars: List[str]  # [N]
    mds: List[str]  # [N]
    flags: np.ndarray  # [N] int

    @property
    def n(self) -> int:
        return len(self.starts)


def simulate_band(
    rng: np.random.Generator,
    ref: np.ndarray,
    hap1: np.ndarray,
    planted: PlantedVariants,
    band: Tuple[int, int],
    depth: float,
    error_rate: float = 0.002,
    somatic_vaf: float = 0.0,
) -> SimulatedReads:
    """Uniform-coverage band of reads over [band[0], band[1]).

    Reads draw haplotype 0/1 with p=0.5; hap-1 reads spanning an indel get
    indel CIGARs (built in a small Python loop — indels are sparse);
    everything else is vectorized. somatic_vaf > 0 additionally flips
    planted.somatic_pos bases on a per-read Bernoulli(somatic_vaf)."""
    lo, hi = band
    length = len(ref)
    hi = min(hi, length)
    n = int((hi - lo) * depth / READ_LEN)
    if n <= 0:
        return SimulatedReads(
            np.empty(0, dtype=np.int64), [], [], [], np.empty(0, dtype=int)
        )
    starts = rng.integers(
        max(0, lo - READ_LEN + 1), max(1, hi - 1), size=n, dtype=np.int64
    )
    starts = np.sort(np.clip(starts, 0, length - READ_LEN))
    hap = rng.integers(0, 2, size=n)
    flags = np.where(rng.random(n) < 0.5, 0, 16)

    # hap-1 reads spanning an indel -> per-read Python path
    indel_pos = np.sort(np.concatenate([planted.ins_pos, planted.del_pos]))
    spans_indel = np.zeros(n, dtype=bool)
    if len(indel_pos):
        j = np.searchsorted(indel_pos, starts, side="left")
        k = np.clip(j, 0, len(indel_pos) - 1)
        # insertion at anchor p needs s < p (anchor inside read);
        # deletion at p needs s < p; both need p within the read span
        spans_indel = (
            (hap == 1)
            & (j < len(indel_pos))
            & (indel_pos[k] > starts)
            & (indel_pos[k] < starts + READ_LEN - 4)
        )
    plain = ~spans_indel

    # ---- vectorized plain reads (chunked: the [chunk, READ_LEN] gather
    # matrices stay ~tens of MB even for million-read bands) ----
    p_starts = starts[plain]
    p_hap = hap[plain]
    np_plain = len(p_starts)
    seqs: List[bytes] = []
    mds: List[str] = []
    chunk = 200_000
    for c0 in range(0, np_plain, chunk):
        c_starts = p_starts[c0 : c0 + chunk]
        c_hap = p_hap[c0 : c0 + chunk]
        nc = len(c_starts)
        gather = c_starts[:, None] + np.arange(READ_LEN, dtype=np.int64)[None, :]
        seq_mat = np.where(
            (c_hap == 1)[:, None], hap1[gather], ref[gather]
        ).astype(np.uint8)

        # somatic flips (tumor bands): per-read Bernoulli per covered site
        if somatic_vaf > 0 and len(planted.somatic_pos):
            for sp, sa in zip(planted.somatic_pos, planted.somatic_alt):
                covered = (c_starts <= sp) & (sp < c_starts + READ_LEN)
                take = covered & (rng.random(nc) < somatic_vaf)
                seq_mat[take, sp - c_starts[take]] = sa

        # sequencing errors
        n_err = rng.poisson(READ_LEN * error_rate, size=nc)
        err_reads = np.repeat(np.arange(nc), n_err)
        if len(err_reads):
            err_offs = rng.integers(0, READ_LEN, size=len(err_reads))
            cur = seq_mat[err_reads, err_offs]
            cur_idx = np.searchsorted(BASES, cur)
            seq_mat[err_reads, err_offs] = BASES[
                (cur_idx + rng.integers(1, 4, size=len(err_reads))) % 4
            ]

        # MD from final mismatch mask (vs reference)
        ref_mat = ref[gather]
        mm = seq_mat != ref_mat
        mm_per_read = mm.sum(axis=1)
        seq_blob = seq_mat.tobytes()
        seqs.extend(
            seq_blob[i * READ_LEN : (i + 1) * READ_LEN] for i in range(nc)
        )
        c_mds = ["100"] * nc
        for i in np.flatnonzero(mm_per_read):
            offs = np.flatnonzero(mm[i])
            c_mds[i] = _md_from_mismatches(offs, bytes(ref_mat[i, offs]))
        mds.extend(c_mds)
    cigars = [f"{READ_LEN}M"] * np_plain

    out_starts = [p_starts]
    out_seqs = [seqs]
    out_cigars = [cigars]
    out_mds = [mds]
    out_flags = [flags[plain]]

    # ---- indel-spanning hap-1 reads (sparse Python loop) ----
    idx = np.flatnonzero(spans_indel)
    if len(idx):
        ins_set = {int(p): s for p, s in zip(planted.ins_pos, planted.ins_seq)}
        del_set = {
            int(p): int(l) for p, l in zip(planted.del_pos, planted.del_len)
        }
        i_starts, i_seqs, i_cigars, i_mds, i_flags = [], [], [], [], []
        jj = np.searchsorted(indel_pos, starts[idx], side="left")
        for ri, j in zip(idx, jj):
            s = int(starts[ri])
            p = int(indel_pos[min(j, len(indel_pos) - 1)])
            if p in ins_set:
                ins = ins_set[p]
                a = p - s + 1  # ref bases through the anchor
                b = READ_LEN - a - len(ins)
                if b < 1:
                    continue
                seq = bytes(ref[s : p + 1]) + ins + bytes(ref[p + 1 : p + 1 + b])
                cigar = f"{a}M{len(ins)}I{b}M"
                md = str(a + b)
            else:
                d = del_set[p]
                m1 = p - s
                b = READ_LEN - m1
                if p + d + b > length:
                    continue
                seq = bytes(ref[s:p]) + bytes(ref[p + d : p + d + b])
                cigar = f"{m1}M{d}D{b}M"
                md = f"{m1}^{bytes(ref[p:p + d]).decode()}{b}"
            i_starts.append(s)
            i_seqs.append(seq)
            i_cigars.append(cigar)
            i_mds.append(md)
            i_flags.append(int(flags[ri]))
        if i_starts:
            out_starts.append(np.asarray(i_starts, dtype=np.int64))
            out_seqs.append(i_seqs)
            out_cigars.append(i_cigars)
            out_mds.append(i_mds)
            out_flags.append(np.asarray(i_flags, dtype=int))

    starts_all = np.concatenate(out_starts)
    order = np.argsort(starts_all, kind="stable")
    seqs_all = [s for part in out_seqs for s in part]
    cigars_all = [c for part in out_cigars for c in part]
    mds_all = [m for part in out_mds for m in part]
    flags_all = np.concatenate(out_flags)
    return SimulatedReads(
        starts=starts_all[order],
        seqs=[seqs_all[i] for i in order],
        cigars=[cigars_all[i] for i in order],
        mds=[mds_all[i] for i in order],
        flags=flags_all[order],
    )


def overflow_clump(
    rng: np.random.Generator,
    ref: np.ndarray,
    anchor: int,
    n_alleles: int = 12,
    per_allele: int = 4,
) -> SimulatedReads:
    """Reads carrying n_alleles DISTINCT insertion sequences at one anchor
    locus — blows past the allele-dictionary cap (K=8 default) to force the
    overflow -> exact-host path."""
    starts, seqs, cigars, mds, flags = [], [], [], [], []
    seen = set()
    while len(seen) < n_alleles:
        seen.add(bytes(BASES[rng.integers(0, 4, size=3)]))
    for ins in sorted(seen):
        for _ in range(per_allele):
            s = anchor - int(rng.integers(20, 70))
            a = anchor - s + 1
            b = READ_LEN - a - len(ins)
            seq = bytes(ref[s : anchor + 1]) + ins + bytes(
                ref[anchor + 1 : anchor + 1 + b]
            )
            starts.append(s)
            seqs.append(seq)
            cigars.append(f"{a}M{len(ins)}I{b}M")
            mds.append(str(a + b))
            flags.append(0)
    order = np.argsort(np.asarray(starts), kind="stable")
    return SimulatedReads(
        starts=np.asarray(starts, dtype=np.int64)[order],
        seqs=[seqs[i] for i in order],
        cigars=[cigars[i] for i in order],
        mds=[mds[i] for i in order],
        flags=np.asarray(flags, dtype=int)[order],
    )


def merge_reads(parts: Sequence[SimulatedReads]) -> SimulatedReads:
    parts = [p for p in parts if p.n]
    if not parts:
        return SimulatedReads(
            np.empty(0, dtype=np.int64), [], [], [], np.empty(0, dtype=int)
        )
    starts = np.concatenate([p.starts for p in parts])
    order = np.argsort(starts, kind="stable")
    seqs = [s for p in parts for s in p.seqs]
    cigars = [c for p in parts for c in p.cigars]
    mds = [m for p in parts for m in p.mds]
    flags = np.concatenate([p.flags for p in parts])
    return SimulatedReads(
        starts=starts[order],
        seqs=[seqs[i] for i in order],
        cigars=[cigars[i] for i in order],
        mds=[mds[i] for i in order],
        flags=flags[order],
    )


def write_sam(
    path: str,
    contigs: Dict[str, Tuple[int, SimulatedReads]],
    sample: str = "sim",
) -> int:
    """Write a coordinate-sorted SAM; returns total records written."""
    qual = QUAL_CHAR * READ_LEN
    total = 0
    with open(path, "w") as out:
        out.write("@HD\tVN:1.5\tSO:coordinate\n")
        for name, (length, _reads) in contigs.items():
            out.write(f"@SQ\tSN:{name}\tLN:{length}\n")
        out.write(f"@RG\tID:rg1\tSM:{sample}\n")
        for name, (_length, reads) in contigs.items():
            lines = []
            for i in range(reads.n):
                lines.append(
                    f"r{total + i:08d}\t{reads.flags[i]}\t{name}\t"
                    f"{reads.starts[i] + 1}\t60\t{reads.cigars[i]}\t*\t0\t0\t"
                    f"{reads.seqs[i].decode()}\t{qual}\t"
                    f"MD:Z:{reads.mds[i]}\tRG:Z:rg1"
                )
                if len(lines) >= 100_000:
                    out.write("\n".join(lines) + "\n")
                    lines = []
            if lines:
                out.write("\n".join(lines) + "\n")
            total += reads.n
    return total


def make_scale_fixture(
    out_dir: str,
    scale: float = 1.0,
    depth_scale: float = 1.0,
    seed: int = 2026,
) -> dict:
    """Build the production-scale fixture set (idempotent — reuses files if
    the manifest matches). At scale=1.0:

      scale.germline.sam : contig deep1m (1 Mbp)  @ 25x
                           + band [300k,400k)     @ +1000x
                           + spike [350k,352k)    @ +8000x
                           + 2 overflow clumps (>K distinct ins alleles)
                           contig shallow8m (8 Mbp) @ 12x
      scale.tumor.sam    : deep1m, same bands, somatic SNVs at VAF 0.35
      scale.normal.sam   : deep1m @ 25x (independent reads)

    scale multiplies contig lengths; depth_scale multiplies band depths
    (tests shrink both independently). Returns the manifest (paths, read
    counts, planted truth)."""
    os.makedirs(out_dir, exist_ok=True)
    manifest_path = os.path.join(out_dir, "manifest.json")
    key = {"version": 4, "scale": scale, "depth_scale": depth_scale,
           "seed": seed, "read_len": READ_LEN}
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path) as fh:
                manifest = json.load(fh)
            if manifest.get("key") == key and all(
                os.path.exists(os.path.join(out_dir, f))
                for f in manifest["files"].values()
            ):
                return manifest
        except (ValueError, KeyError):
            pass

    rng = np.random.default_rng(np.random.PCG64(seed))
    deep_len = int(1_000_000 * min(scale, 1.0) if scale < 1 else 1_000_000)
    shallow_len = int(8_000_000 * scale)
    band = (int(0.3 * deep_len), int(0.4 * deep_len))
    spike = (int(0.35 * deep_len), int(0.35 * deep_len) + max(500, deep_len // 500))

    deep_ref = simulate_reference(rng, deep_len)
    deep_planted = plant_germline_variants(rng, deep_ref)
    plant_somatic_snvs(
        rng, deep_ref, deep_planted, band, count=max(4, int(30 * scale))
    )
    deep_hap1 = _hap1_sequence(deep_ref, deep_planted)

    shallow_ref = simulate_reference(rng, shallow_len)
    shallow_planted = plant_germline_variants(rng, shallow_ref)
    shallow_hap1 = _hap1_sequence(shallow_ref, shallow_planted)

    def deep_bands(vaf: float) -> SimulatedReads:
        parts = [
            simulate_band(
                rng, deep_ref, deep_hap1, deep_planted, (0, deep_len),
                25 * depth_scale, somatic_vaf=vaf,
            ),
            simulate_band(
                rng, deep_ref, deep_hap1, deep_planted, band,
                1000 * depth_scale, somatic_vaf=vaf,
            ),
            simulate_band(
                rng, deep_ref, deep_hap1, deep_planted, spike,
                8000 * depth_scale, somatic_vaf=vaf,
            ),
            overflow_clump(rng, deep_ref, spike[0] + (spike[1] - spike[0]) // 2),
            overflow_clump(rng, deep_ref, band[0] + 1000),
        ]
        return merge_reads(parts)

    files = {}
    counts = {}

    germline_deep = deep_bands(vaf=0.0)
    shallow_reads = simulate_band(
        rng, shallow_ref, shallow_hap1, shallow_planted,
        (0, shallow_len), 12 * depth_scale,
    )
    files["germline"] = "scale.germline.sam"
    counts["germline"] = write_sam(
        os.path.join(out_dir, files["germline"]),
        {
            "deep1m": (deep_len, germline_deep),
            "shallow8m": (shallow_len, shallow_reads),
        },
    )
    del germline_deep, shallow_reads

    tumor = deep_bands(vaf=0.35)
    files["tumor"] = "scale.tumor.sam"
    counts["tumor"] = write_sam(
        os.path.join(out_dir, files["tumor"]), {"deep1m": (deep_len, tumor)}
    )
    del tumor

    normal = merge_reads(
        [
            simulate_band(
                rng, deep_ref, deep_hap1, deep_planted, (0, deep_len),
                25 * depth_scale,
            )
        ]
    )
    files["normal"] = "scale.normal.sam"
    counts["normal"] = write_sam(
        os.path.join(out_dir, files["normal"]), {"deep1m": (deep_len, normal)}
    )
    del normal

    # BAM forms (+ .bai) so scale runs exercise the production streaming
    # path: per-task byte-range pushdown, index-depth partitioning, and
    # per-process shard loading in multi-host runs.
    from guacamole_tpu_torch.callers.streaming import ensure_bam_index
    from guacamole_tpu_torch.gio.bamwrite import sam_to_bam

    for kind in list(files):
        bam_name = files[kind].replace(".sam", ".bam")
        n_bam = sam_to_bam(
            os.path.join(out_dir, files[kind]),
            os.path.join(out_dir, bam_name),
        )
        assert n_bam == counts[kind]
        ensure_bam_index(os.path.join(out_dir, bam_name))
        files[kind + "_bam"] = bam_name

    manifest = {
        "key": key,
        "files": files,
        "counts": counts,
        "contigs": {"deep1m": deep_len, "shallow8m": shallow_len},
        "bands": {"background_x": 25 * depth_scale, "band": list(band),
                  "band_x": 1000 * depth_scale, "spike": list(spike),
                  "spike_x": 8000 * depth_scale, "shallow_x": 12 * depth_scale},
        "truth": {
            "deep1m": deep_planted.to_json(),
            "shallow8m": shallow_planted.to_json(),
        },
    }
    with open(manifest_path, "w") as fh:
        json.dump(manifest, fh)
    return manifest


def make_sv_fixture(
    out_dir: str,
    length: int = 2_000_000,
    depth: int = 20,
    mean_insert: int = 350,
    sd_insert: int = 40,
    deletions: Tuple[Tuple[int, int], ...] = ((500_000, 6_000),
                                              (1_300_000, 9_000)),
    seed: int = 2027,
    zygosities: Optional[Sequence[str]] = None,
    noise_rate: float = 0.0,
) -> dict:
    """Paired-end fixture with planted large deletions for the
    structural-variant caller (idempotent, cached by manifest key).

    Fragments sample from two haplotypes. HOMOZYGOUS deletions are
    excised from both haplotypes; HETEROZYGOUS ones only from the second
    (`zygosities` parallels `deletions`, entries "het"/"hom"; default all
    het — the round-4 behavior). A fragment whose insert window straddles
    an excised interval maps back to reference coordinates with its
    insert inflated by the deletion length — exactly the discordant-pair
    signal the caller's median+5*MAD threshold detects
    (cf. reference .../StructuralVariantCaller.scala:102-129).
    Reads never cross breakpoints (such fragments are dropped), so every
    read aligns exactly (MD = read length); pairs carry proper RNEXT/
    PNEXT/TLEN.

    noise_rate: fraction of fragments given a random inflated insert
    (uniform 1-8 kb over the mean) UNRELATED to any planted deletion —
    isolated discordant pairs that stress the clique stage's precision
    (a real caller sees mapping-artifact discordants at this rate).

    Returns the manifest with the planted truth intervals + zygosities.
    """
    os.makedirs(out_dir, exist_ok=True)
    manifest_path = os.path.join(out_dir, "sv_manifest.json")
    zygs = list(zygosities) if zygosities is not None else ["het"] * len(
        deletions
    )
    assert len(zygs) == len(deletions) and all(
        z in ("het", "hom") for z in zygs
    )
    key = {"version": 2, "length": length, "depth": depth,
           "mean_insert": mean_insert, "sd_insert": sd_insert,
           "deletions": [list(d) for d in deletions], "seed": seed,
           "zygosities": zygs, "noise_rate": noise_rate,
           "read_len": READ_LEN}
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path) as fh:
                manifest = json.load(fh)
            if manifest.get("key") == key and os.path.exists(
                os.path.join(out_dir, manifest["files"]["sv_sam"])
            ):
                return manifest
        except (ValueError, KeyError):
            pass

    rng = np.random.default_rng(seed)
    ref = simulate_reference(rng, length)
    order_idx = np.argsort([d[0] for d in deletions])
    dels = [deletions[i] for i in order_idx]
    dzygs = [zygs[i] for i in order_idx]

    def hap_model(hap_dels):
        """Coordinate model of a haplotype with `hap_dels` excised:
        (hap length, breakpoints in hap coords, hap->ref mapper)."""
        if not hap_dels:
            return length, np.zeros(0, np.int64), lambda p: p
        starts_ref = np.asarray([d[0] for d in hap_dels], dtype=np.int64)
        lens = np.asarray([d[1] for d in hap_dels], dtype=np.int64)
        removed_before = np.concatenate([[0], np.cumsum(lens)[:-1]])
        bps = starts_ref - removed_before
        cum = np.cumsum(lens)

        def to_ref(pos):
            shift = np.zeros(len(pos), dtype=np.int64)
            for b, rl in zip(bps, cum):
                shift = np.where(pos >= b, rl, shift)
            return pos + shift

        return length - int(lens.sum()), bps, to_ref

    # Haplotype 0 carries the hom deletions; haplotype 1 carries all.
    hom_dels = [d for d, z in zip(dels, dzygs) if z == "hom"]
    h0_len, h0_bps, h0_to_ref = hap_model(hom_dels)
    h1_len, h1_bps, h1_to_ref = hap_model(dels)

    n_frags = int(depth * length / (2 * READ_LEN))
    hap = rng.integers(0, 2, size=n_frags)
    inserts = np.maximum(
        rng.normal(mean_insert, sd_insert, size=n_frags).astype(np.int64),
        2 * READ_LEN + 10,
    )
    is_noise = np.zeros(n_frags, dtype=bool)
    if noise_rate > 0:
        is_noise = rng.random(n_frags) < noise_rate
        inserts = np.where(
            is_noise,
            inserts + rng.integers(1_000, 8_000, size=n_frags),
            inserts,
        )
    hap_len = np.where(hap == 0, h0_len, h1_len)
    starts = (rng.random(n_frags) * (hap_len - inserts - 1)).astype(np.int64)
    r1 = starts
    r2 = inserts + starts - READ_LEN  # mate start (same haplotype coords)
    # Drop fragments whose READS cross a breakpoint of their haplotype
    # (split reads).
    keep = np.ones(n_frags, dtype=bool)
    for hap_idx, bps in ((0, h0_bps), (1, h1_bps)):
        mask = hap == hap_idx
        for bp in bps:
            for s in (r1, r2):
                keep &= ~(mask & (s < bp) & (s + READ_LEN > bp))
    r1, r2, hap = r1[keep], r2[keep], hap[keep]
    # Map read starts to reference coordinates.
    r1_ref = np.where(hap == 1, h1_to_ref(r1), h0_to_ref(r1))
    r2_ref = np.where(hap == 1, h1_to_ref(r2), h0_to_ref(r2))
    tlen = r2_ref + READ_LEN - r1_ref  # leftmost-to-rightmost span

    contig = "svcontig"
    qual = QUAL_CHAR * READ_LEN
    n = len(r1_ref)
    # Emit both mates, coordinate-sorted.
    rec_start = np.concatenate([r1_ref, r2_ref])
    rec_mate = np.concatenate([r2_ref, r1_ref])
    rec_tlen = np.concatenate([tlen, -tlen])
    rec_flag = np.concatenate([
        np.full(n, 1 | 2 | 32 | 64, dtype=np.int64),   # first, mate rev
        np.full(n, 1 | 2 | 16 | 128, dtype=np.int64),  # second, reverse
    ])
    rec_name = np.concatenate(
        [np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64)]
    )
    order = np.argsort(rec_start, kind="stable")
    sam_name = "sv.pairs.sam"
    with open(os.path.join(out_dir, sam_name), "w") as out:
        out.write("@HD\tVN:1.5\tSO:coordinate\n")
        out.write(f"@SQ\tSN:{contig}\tLN:{length}\n")
        out.write("@RG\tID:rg1\tSM:sim\n")
        lines = []
        for i in order:
            s = int(rec_start[i])
            seq = ref[s : s + READ_LEN].tobytes().decode()
            lines.append(
                f"p{int(rec_name[i]):08d}\t{int(rec_flag[i])}\t{contig}\t"
                f"{s + 1}\t60\t{READ_LEN}M\t=\t{int(rec_mate[i]) + 1}\t"
                f"{int(rec_tlen[i])}\t{seq}\t{qual}\t"
                f"MD:Z:{READ_LEN}\tRG:Z:rg1"
            )
            if len(lines) >= 100_000:
                out.write("\n".join(lines) + "\n")
                lines = []
        if lines:
            out.write("\n".join(lines) + "\n")

    manifest = {
        "key": key,
        "files": {"sv_sam": sam_name},
        "counts": {"records": 2 * n, "pairs": n},
        "contig": contig,
        "length": length,
        "truth_deletions": [
            [int(s), int(s + l)] for s, l in dels
        ],
        "truth_zygosities": dzygs,
        "noise_rate": noise_rate,
    }
    with open(manifest_path, "w") as fh:
        json.dump(manifest, fh)
    return manifest
