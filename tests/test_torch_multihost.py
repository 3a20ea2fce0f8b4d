"""The port's multi-process runtime (guacamole_tpu_torch/parallel/multihost.py
and the CLI helpers around it), with --device cpu.

Two OS processes join a gloo process group at a localhost coordinator and
run the port's CLI on their loci shards; process 0 writes the merged
output, which must equal a single-process run's (germline-threshold,
variant-support, and structural-variant's contig split). Failure paths: a
hung peer and a dead peer make the survivor exit 42 within its --timeout;
a process killed before the merge leaves the survivor's shard on disk, and
--recover in one process writes output byte-equal to an undisturbed run.
The single-process --recover runs in-process too.

Inputs are simulated (utils/simulate, scale 0.02, seed 7; make_sv_fixture).
Every wait has its own timeout, every run passes --timeout of 30 s or less,
and each helper kills its children in a `finally`.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from guacamole_tpu.utils.simulate import make_scale_fixture, make_sv_fixture
from guacamole_tpu_torch import cli as port_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    out = tmp_path_factory.mktemp("sim")
    manifest = make_scale_fixture(str(out), scale=0.02, seed=7)
    files = {k: os.path.join(str(out), v) for k, v in manifest["files"].items()}
    files["sites"] = os.path.join(str(out), "sites.vcf")
    assert port_cli.main(
        ["germline-threshold", "--reads", files["germline_bam"],
         "--threshold", "25", "--out", files["sites"], "--device", "cpu"]
    ) == 0
    return files


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv, log_path, env=None, code=None):
    log = open(log_path, "w")
    cmd = [sys.executable] + (
        ["-c", code] if code else ["-m", "guacamole_tpu_torch.cli", *argv]
    )
    proc = subprocess.Popen(
        cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
        env=dict(os.environ, **(env or {})),
    )
    log.close()
    proc.log_path = log_path
    return proc


def _log(proc):
    with open(proc.log_path) as fh:
        return fh.read()


def _run_all(procs, timeout=WAIT_S):
    """Exit codes of procs; kills every one still running on the way out."""
    try:
        return [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def _multi_argv(argv, coordinator, pid, n=2, timeout_s=30):
    return [*argv, "--device", "cpu", "--coordinator", coordinator,
            "--num-processes", str(n), "--process-id", str(pid),
            "--timeout", str(timeout_s)]


def _two_process_run(tmp_path, argv, tag, env1=None):
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [
        _spawn(_multi_argv(argv, coordinator, pid),
               tmp_path / f"{tag}-p{pid}.log", env=env1 if pid else None)
        for pid in range(2)
    ]
    return procs, _run_all(procs)


def _single(argv):
    assert port_cli.main([*argv, "--device", "cpu", "--debug"]) == 0


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("command", ["germline-threshold", "variant-support"])
def test_two_process_run_equals_single(tmp_path, fx, command):
    if command == "germline-threshold":
        argv = ["germline-threshold", "--reads", fx["germline_bam"],
                "--threshold", "25", "--out"]
        ext = "vcf"
    else:
        # One BAM: a shard's loci filter names every contig of the sites,
        # and the tumor BAM lacks shallow8m (the JAX code refuses that too).
        argv = ["variant-support", "-v", fx["sites"], fx["germline_bam"],
                "-o"]
        ext = "csv"
    multi, single = tmp_path / f"multi.{ext}", tmp_path / f"single.{ext}"
    procs, codes = _two_process_run(tmp_path, [*argv, str(multi)], command)
    assert codes == [0, 0], [_log(p) for p in procs]
    assert "Process 0/2 loci shard" in _log(procs[0]) or command != (
        "germline-threshold")
    _single([*argv, str(single)])
    assert _bytes(multi) == _bytes(single)
    assert len(_bytes(single).splitlines()) > 100
    assert not os.path.exists(str(multi) + ".shards")


def _two_contig_sv_sam(tmp_path):
    """A paired-end SAM of two contigs (two make_sv_fixture runs, the
    second renamed), so that each of two processes takes one contig."""
    parts = []
    for name, seed, deletion in (("sva", 11, (90_000, 4_000)),
                                 ("svb", 12, (60_000, 5_000))):
        d = tmp_path / name
        m = make_sv_fixture(str(d), length=200_000, depth=12,
                            deletions=(deletion,), seed=seed)
        with open(d / m["files"]["sv_sam"]) as fh:
            lines = fh.read().replace(m["contig"], name).splitlines(True)
        parts.append(lines)
    header = [ln for p in parts for ln in p if ln.startswith("@SQ")]
    body = [ln for p in parts for ln in p if not ln.startswith("@")]
    path = tmp_path / "two.sam"
    with open(path, "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        fh.writelines(header + body)
    return str(path)


def test_two_process_structural_variant_splits_contigs(tmp_path):
    sam = _two_contig_sv_sam(tmp_path)
    multi, single = tmp_path / "multi.txt", tmp_path / "single.txt"
    argv = ["structural-variant", "--reads", sam, "--output"]
    procs, codes = _two_process_run(tmp_path, [*argv, str(multi)], "sv")
    assert codes == [0, 0], [_log(p) for p in procs]
    _single([*argv, str(single)])
    text = _bytes(single).decode()
    assert _bytes(multi) == _bytes(single)
    assert "GenomeRange(sva," in text and "GenomeRange(svb," in text


def _survivor(tmp_path, fx, coordinator, tag, timeout_s=5):
    argv = ["germline-threshold", "--reads", fx["germline_bam"],
            "--threshold", "25", "--out", str(tmp_path / f"{tag}.vcf")]
    return _spawn(_multi_argv(argv, coordinator, 0, timeout_s=timeout_s),
                  tmp_path / f"{tag}-p0.log")


def _peer_code(coordinator, then):
    host, port = coordinator.rsplit(":", 1)
    return (
        "import datetime, os, time\n"
        "import torch.distributed as dist\n"
        f"store = dist.TCPStore({host!r}, {port}, 2, False,\n"
        "                      timeout=datetime.timedelta(seconds=60))\n"
        "dist.init_process_group('gloo', store=store, rank=1, world_size=2)\n"
        + then + "\n"
    )


@pytest.mark.parametrize("peer", ["hung", "dead"])
def test_a_lost_peer_makes_the_survivor_exit_42(tmp_path, fx, peer):
    """A peer that joins the group and then never enters a collective
    (hung), or exits (dead): the survivor's first collective must end the
    process with exit 42 and the watchdog's one line, within its
    --timeout of 5 s plus its own work, never hang and never exit 0."""
    coordinator = f"127.0.0.1:{_free_port()}"
    then = "time.sleep(300)" if peer == "hung" else "os._exit(0)"
    victim = _spawn([], tmp_path / "peer.log",
                    code=_peer_code(coordinator, then))
    try:
        t0 = time.time()
        survivor = _survivor(tmp_path, fx, coordinator, peer)
        (code,) = _run_all([survivor])
        elapsed = time.time() - t0
        log = _log(survivor)
        assert code == 42, log
        assert "did not complete within" in log and "aborting" in log, log
        assert elapsed < 60, f"survivor took {elapsed:.0f}s to abort"
        assert not os.path.exists(tmp_path / f"{peer}.vcf")
    finally:
        if victim.poll() is None:
            victim.kill()
        victim.wait(timeout=30)


def test_recover_after_killed_process(tmp_path, fx):
    """Process 1 dies before it persists or merges (the fault hook, exit
    43); process 0's collective fails (exit 42) with its shard on disk;
    --recover in one process re-executes only the lost shard and writes
    output byte-equal to an undisturbed run, then removes the shards."""
    out = tmp_path / "multi.vcf"
    argv = ["germline-threshold", "--reads", fx["germline_bam"],
            "--threshold", "25", "--out", str(out)]
    procs, codes = _two_process_run(
        tmp_path, argv, "rec", env1={"GUAC_TEST_EXIT_BEFORE_MERGE": "1"})
    assert codes == [42, 43], [_log(p) for p in procs]
    shards = tmp_path / "multi.vcf.shards"
    assert not out.exists()
    assert sorted(os.listdir(shards)) == ["shard-0-of-2.pkl"]
    recover = _spawn([*argv, "--device", "cpu", "--recover", "--timeout",
                      "30"], tmp_path / "recover.log")
    assert _run_all([recover]) == [0], _log(recover)
    assert "Recovering: 1/2 shards on disk" in _log(recover)
    assert not shards.exists()
    single = tmp_path / "single.vcf"
    _single([*argv[:-1], str(single)])
    assert _bytes(out) == _bytes(single)


def test_single_process_recover_in_process(tmp_path, fx, monkeypatch):
    """The single-process --recover needs no process group: it reads the
    shard files a failed run left, calls only the missing shards' loci and
    writes output byte-equal to an undisturbed run."""
    from guacamole_tpu_torch.callers import common
    from guacamole_tpu_torch.gio.load import header_contig_lengths
    from guacamole_tpu_torch.loci.lociset import parse_loci
    from guacamole_tpu_torch.parallel.multihost import (
        MultihostRuntime,
        persist_shard,
        shard_loci_expression,
    )

    argv = ["germline-threshold", "--reads", fx["germline_bam"],
            "--threshold", "25", "--out"]
    single = str(tmp_path / "single.vcf")
    _single([*argv, single])
    # The records that process 1 of 3 would have persisted: those of a run
    # over its loci shard, as they reach the writer.
    written = []
    write = common.write_variants

    def keep(records, *args, **kwargs):
        written.append(list(records))
        return write(records, *args, **kwargs)

    monkeypatch.setattr(common, "write_variants", keep)
    loci = parse_loci("all").result(header_contig_lengths(fx["germline_bam"]))
    expr = shard_loci_expression(MultihostRuntime(1, 3), loci)
    _single([*argv, str(tmp_path / "part.vcf"), "--loci", expr])
    monkeypatch.setattr(common, "write_variants", write)
    assert len(written) == 1 and written[0]
    out = str(tmp_path / "out.vcf")
    persist_shard(out, 1, 3, written[0])
    _single([*argv, out, "--recover"])
    assert _bytes(out) == _bytes(single)
    assert not os.path.exists(out + ".shards")
    with pytest.raises(SystemExit, match="nothing to resume"):
        port_cli.main([*argv, str(tmp_path / "none.vcf"), "--device", "cpu",
                       "--recover"])


def test_multihost_helpers_single_process():
    """The helper API degrades to identity in single-process runs."""
    from guacamole_tpu_torch.loci.lociset import parse_loci
    from guacamole_tpu_torch.parallel.multihost import (
        SINGLE,
        allreduce_counters,
        barrier,
        bootstrap,
        gather_bytes,
        gather_objects,
        shard_loci_expression,
    )

    assert not SINGLE.active and SINGLE.is_writer
    assert bootstrap(num_processes=1) is SINGLE
    assert allreduce_counters(SINGLE, {"reads": 7}) == {"reads": 7}
    assert gather_bytes(SINGLE, b"abc") == [b"abc"]
    assert gather_objects(SINGLE, [1, 2]) == [1, 2]
    barrier(SINGLE, "noop")
    loci = parse_loci("chrM:0-100").result({"chrM": 16571})
    assert shard_loci_expression(SINGLE, loci) == "chrM:0-100"


def test_shard_expressions_cover_and_partition():
    from guacamole_tpu_torch.loci.lociset import parse_loci
    from guacamole_tpu_torch.parallel.multihost import (
        MultihostRuntime,
        missing_shards_expression,
        shard_loci_expression,
    )

    loci = parse_loci("chrM:0-16571").result({"chrM": 16571})
    covered = np.zeros(16571, dtype=np.int32)
    for pid in range(3):
        expr = shard_loci_expression(MultihostRuntime(pid, 3), loci)
        shard = parse_loci(expr).result({"chrM": 16571})
        for start, end in shard.on_contig("chrM").ranges:
            covered[start:end] += 1
    assert (covered == 1).all()
    assert missing_shards_expression(loci, 3, {0: [], 2: []}) == (
        shard_loci_expression(MultihostRuntime(1, 3), loci))


@pytest.mark.parametrize(
    "kwargs, message",
    [
        (dict(num_processes=2, process_id=0), "--coordinator"),
        (dict(num_processes=2, coordinator="x:1"), "--process-id"),
        (dict(num_processes=2, process_id=2, coordinator="x:1"), "below"),
        (dict(num_processes=2, process_id=0, coordinator="x"), "HOST:PORT"),
    ],
)
def test_bootstrap_refuses_an_incomplete_group(kwargs, message):
    from guacamole_tpu_torch.parallel.multihost import bootstrap

    with pytest.raises(ValueError, match=message):
        bootstrap(**kwargs)
