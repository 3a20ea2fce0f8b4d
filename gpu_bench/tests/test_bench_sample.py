"""The sample generator: the same seed gives the same reads and the same
bytes; the BAM and .bai it writes are what the program reads and what the
program's own indexer would write."""

import os

import numpy as np

import sample as S
from conftest import HERE


def _config(name="tiny_germline"):
    return S.load_config(os.path.join(HERE, name + ".json"))


def test_same_seed_same_sample_and_bytes(tmp_path):
    cfg = _config()
    a = S.make_sample(cfg, 2**31 + 7)
    b = S.make_sample(cfg, 2**31 + 7)
    c = S.make_sample(cfg, 2**31 + 8)
    ra, rb = a.reads["reads"], b.reads["reads"]
    for field in ("start", "seq", "qual", "mapq", "reverse", "kind",
                  "anchor", "ilen"):
        assert np.array_equal(getattr(ra, field), getattr(rb, field))
    assert not np.array_equal(ra.seq, c.reads["reads"].seq)
    S.write_bam(str(tmp_path / "a.bam"), ra, a.reference, a.contig)
    S.write_bam(str(tmp_path / "b.bam"), rb, b.reference, b.contig)
    for ext in (".bam", ".bam.bai"):
        assert (tmp_path / ("a" + ext)).read_bytes() == (
            tmp_path / ("b" + ext)).read_bytes()


def test_counts_are_fixed_by_the_configuration():
    cfg = _config("tiny_tumor_normal")
    for seed in (1, 2):
        smp = S.make_sample(cfg, seed)
        assert smp.truth["snv"] == 200 and smp.truth["indel"] == 20
        assert smp.truth["somatic"] == 8
        # Reads near an indel that an aligner would clip are dropped: a
        # few in a thousand.
        per_target = round(1000 * 200 / (200 * 150 / 349))
        assert 0.99 * 8 * per_target <= smp.reads["tumor"].n <= 8 * per_target


def test_qualities_are_the_bins_with_their_shares():
    cfg = _config()
    q = S.make_sample(cfg, 3).reads["reads"].qual
    bins = cfg["genome"]["quality"]["bins"]
    shares = cfg["genome"]["quality"]["shares"]
    assert set(np.unique(q).tolist()) == set(bins)
    for b, share in zip(bins, shares):
        assert abs(np.mean(q == b) - share) < 0.004


def test_the_program_reads_the_bam_and_indexes_it_alike(tmp_path):
    from guacamole_tpu_torch.gio.bai import BamIndex, build_bam_index
    from guacamole_tpu_torch.runtime.columnar import decode_bam_columnar

    cfg = _config()
    smp = S.make_sample(cfg, 11)
    rs = smp.reads["reads"]
    bam = str(tmp_path / "x.bam")
    S.write_bam(bam, rs, smp.reference, smp.contig)
    cols = decode_bam_columnar(bam)
    assert cols.n == rs.n
    assert np.array_equal(np.asarray(cols.start), rs.start)
    assert np.array_equal(np.asarray(cols.mapq), rs.mapq)
    build_bam_index(bam, str(tmp_path / "port.bai"))
    ours, port = BamIndex(bam + ".bai"), BamIndex(str(tmp_path / "port.bai"))
    assert ours.linear == port.linear
    assert sorted(ours.bins[0]) == sorted(port.bins[0])
    # The last record's chunk ends where the record ends (as samtools
    # writes it); the program's indexer writes the end of the file there.
    last = max(ours.bins[0], key=lambda b: ours.bins[0][b][-1][1])
    for b, chunks in ours.bins[0].items():
        theirs = port.bins[0][b]
        if b == last:
            chunks, theirs = chunks[:-1], theirs[:-1]
            assert ours.bins[0][b][-1][0] == port.bins[0][b][-1][0]
        assert chunks == theirs


def test_md_tags_match_a_base_by_base_walk():
    cfg = _config()
    smp = S.make_sample(cfg, 5)
    rs, ref = smp.reads["reads"], smp.reference
    mat, ln = S.md_tags(rs, ref)
    for i in list(range(0, rs.n, 97)) + np.flatnonzero(rs.kind).tolist():
        if rs.kind[i]:
            want = S._md_indel(rs, i, ref)
        else:
            refm = ref[rs.start[i]: rs.start[i] + rs.seq.shape[1]]
            parts, run = [], 0
            for b, rb in zip(rs.seq[i].tolist(), refm.tolist()):
                if b == rb:
                    run += 1
                else:
                    parts.append(b"%d%c" % (run, rb))
                    run = 0
            want = b"".join(parts) + b"%d" % run
        assert bytes(mat[i, : ln[i]]) == want and mat[i, ln[i]] == 0
