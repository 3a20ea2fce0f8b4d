"""Multi-process runtime of the port: N cooperating processes, one per
host (or several on one host, sharing its cards).

Port of guacamole_tpu/parallel/multihost.py. The reference runs a Spark
program + executors across machines (cf. reference .../Command.scala:51-62
and the YARN deployment in README.md:66-88); the shuffle routes every read
to the executor owning its loci task. Here there is no shuffle: each
process

  1. joins a torch.distributed process group over gloo (a TCP rendezvous
     at the coordinator, process 0): the control plane,
  2. is assigned a contiguous loci shard by `process_index` and loads ONLY
     that shard's reads (BAM-index byte-range pushdown; boundary reads are
     fetched by every process whose shard they overlap — halo duplication
     at the input layer, the analog of DistributedUtil.scala:585-597),
  3. packs/screens/calls its shard locally (its cards form the local part
     of the device mesh),
  4. merges global counters and the called-variant set with gloo
     all_gathers of CPU tensors (the analog of Spark accumulators and the
     program-side `collect` in Common.scala:274-286); process 0 writes the
     single output file (the analog of `coalesce(1)` at Common.scala:293).

No device tensor crosses processes, so the collectives need no NCCL. The
shard files, the recovery and the watchdog are the JAX module's, unchanged
(tests/test_torch_host_copies.py holds them equal); only bootstrap,
_allgather_array and barrier differ. tests/test_torch_multihost.py spawns
two OS processes against a localhost coordinator and holds the merged
output to a single-process run, and the hung-peer, dead-peer and recovery
paths to their exit codes.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import sys
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

# Default bound on any single collective. The reference delegates failure
# handling to Spark's task retry (SURVEY.md §5); here a dead peer would
# otherwise hang every survivor inside a collective forever. NOTE a
# collective also waits for SLOW peers — shard-load skew counts against
# this bound, so the default is generous; tune with --timeout when faster
# failure is worth the skew risk. (gloo also raises when a peer's
# connection closes, which maps to the same abort.)
DEFAULT_DCN_TIMEOUT_S = 900.0


@dataclass(frozen=True)
class MultihostRuntime:
    """This process's place in the (possibly single-process) run."""

    process_index: int
    process_count: int
    # Watchdog bound (seconds) on each DCN collective; <= 0 disables.
    timeout_s: float = DEFAULT_DCN_TIMEOUT_S

    @property
    def active(self) -> bool:
        return self.process_count > 1

    @property
    def is_writer(self) -> bool:
        """Process 0 writes the merged output (the coalesce(1) analog)."""
        return self.process_index == 0


SINGLE = MultihostRuntime(0, 1)


def _watchdog_abort(op: str, timeout_s: float) -> None:
    sys.stderr.write(
        f"guacamole: DCN collective '{op}' did not complete within "
        f"{timeout_s:.0f}s — a peer process died, hung, or is running "
        "far behind (shard skew / long first compile); aborting this "
        "process (re-run the job; raise --timeout if peers are merely "
        "slow)\n"
    )
    sys.stderr.flush()
    # os._exit: the main thread is blocked inside a native collective and
    # cannot unwind; a clean nonzero exit beats an indefinite hang.
    os._exit(42)


@contextlib.contextmanager
def _dcn_watchdog(runtime: MultihostRuntime, op: str):
    """Abort the process (exit 42, one-line error) if a DCN collective
    outlives runtime.timeout_s — so one dead process can't deadlock the
    others; the cluster launcher then sees a nonzero exit and can retry
    the whole batch (the Spark-retry analog at the job level)."""
    if not runtime.active or runtime.timeout_s <= 0:
        yield
        return
    timer = threading.Timer(
        runtime.timeout_s, _watchdog_abort, args=(op, runtime.timeout_s)
    )
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def bootstrap(
    coordinator: str = "",
    num_processes: int = 0,
    process_id: int = -1,
    timeout_s: float = -1.0,
) -> MultihostRuntime:
    """Join the gloo process group of a multi-process run.

    Arguments may come from CLI flags or the GUAC_COORDINATOR /
    GUAC_NUM_PROCESSES / GUAC_PROCESS_ID / GUAC_TIMEOUT environment
    variables (the env form is what a cluster launcher like mpirun or a
    job scheduler injects per task). A single-process run (num_processes
    <= 1) is a no-op returning SINGLE.

    Process 0 serves the rendezvous store at the coordinator address; the
    others connect to it. The rendezvous waits max(30 s, timeout_s) for
    every process to arrive (peers start unevenly), and each later
    collective is bounded by timeout_s. A failed rendezvous aborts with
    the watchdog's exit 42."""
    coordinator = coordinator or os.environ.get("GUAC_COORDINATOR", "")
    if not num_processes:
        num_processes = int(os.environ.get("GUAC_NUM_PROCESSES", "0") or 0)
    if process_id < 0:
        process_id = int(os.environ.get("GUAC_PROCESS_ID", "-1") or -1)
    if timeout_s < 0:
        timeout_s = float(
            os.environ.get("GUAC_TIMEOUT", "") or DEFAULT_DCN_TIMEOUT_S
        )
    if num_processes <= 1:
        return SINGLE
    if not coordinator or process_id < 0:
        raise ValueError(
            "multi-process runs need --coordinator HOST:PORT and "
            "--process-id (or GUAC_COORDINATOR / GUAC_PROCESS_ID)"
        )
    if process_id >= num_processes:
        raise ValueError(
            f"--process-id {process_id} is not below --num-processes "
            f"{num_processes}"
        )
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(
            f"--coordinator {coordinator!r}: expected HOST:PORT"
        )
    from datetime import timedelta

    import torch.distributed as dist

    init_timeout = max(30, int(timeout_s)) if timeout_s > 0 else 300
    # A timeout of 0 disables the watchdog; gloo keeps a bound of its own.
    op_timeout = timeout_s if timeout_s > 0 else 1800
    try:
        store = dist.TCPStore(
            host, int(port), num_processes, process_id == 0,
            timeout=timedelta(seconds=init_timeout),
        )
        dist.init_process_group(
            "gloo", store=store, rank=process_id, world_size=num_processes,
            timeout=timedelta(seconds=op_timeout),
        )
    except (RuntimeError, OSError):
        _watchdog_abort("init_process_group", init_timeout)
    return MultihostRuntime(process_id, num_processes, timeout_s)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_loci_expression(
    runtime: MultihostRuntime, loci_set
) -> Optional[str]:
    """This process's loci shard as a parseable loci expression.

    Uniform split of the global loci set into process_count contiguous
    shards (the cross-host partitioning axis; within the shard the
    per-process partitioner further depth-balances across its tasks).
    Returns None for an empty shard (more hosts than loci ranges' span).
    """
    from guacamole_tpu_torch.loci.partition import partition_loci_uniformly

    partitions = partition_loci_uniformly(runtime.process_count, loci_set)
    shard = partitions.inverse_map().get(runtime.process_index)
    if shard is None or shard.count == 0:
        return None
    parts = []
    for contig in shard.contigs:
        for start, end in shard.on_contig(contig).ranges:
            parts.append(f"{contig}:{start}-{end}")
    return ",".join(parts)


def _allgather_array(
    arr: np.ndarray, runtime: MultihostRuntime = SINGLE, op: str = "allgather"
) -> np.ndarray:
    """All-gather one per-process array (equal shapes everywhere) as gloo
    CPU tensors; returns [P, *arr.shape]. Guarded by the watchdog, and a
    collective that raises (gloo's own timeout, or a connection a dead
    peer closed) takes the watchdog's exit 42 too: a survivor never hangs
    and never exits 0."""
    import torch
    import torch.distributed as dist

    local = torch.from_numpy(np.ascontiguousarray(arr))
    parts = [torch.empty_like(local) for _ in range(runtime.process_count)]
    with _dcn_watchdog(runtime, op):
        try:
            dist.all_gather(parts, local)
        except (RuntimeError, OSError):
            _watchdog_abort(op, runtime.timeout_s)
    return torch.stack(parts).numpy()


def allreduce_counters(
    runtime: MultihostRuntime, counters: Dict[str, int]
) -> Dict[str, int]:
    """Sum named integer counters across all processes (the Spark
    accumulator analog, merged over DCN)."""
    if not runtime.active:
        return dict(counters)
    keys = sorted(counters)
    local = np.asarray([counters[k] for k in keys], dtype=np.int64)
    summed = _allgather_array(local, runtime, "allreduce_counters").sum(axis=0)
    return {k: int(v) for k, v in zip(keys, summed)}


def gather_bytes(runtime: MultihostRuntime, payload: bytes) -> List[bytes]:
    """All-gather one variable-length byte string per process.

    Two DCN collectives: lengths first, then the max-length-padded
    payloads (process_allgather requires equal shapes per process).
    """
    if not runtime.active:
        return [payload]
    lengths = _allgather_array(
        np.asarray([len(payload)], np.int64), runtime, "gather_bytes/lengths"
    )[:, 0]
    width = max(1, int(lengths.max()))
    buf = np.zeros(width, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    stacked = _allgather_array(buf, runtime, "gather_bytes/payload")
    return [
        stacked[p, : int(lengths[p])].tobytes()
        for p in range(runtime.process_count)
    ]


def gather_objects(runtime: MultihostRuntime, items: Sequence) -> List:
    """All-gather per-process object lists (pickled over DCN) and return
    the concatenation in process order — the program-collect analog.
    Every process receives the full merged list."""
    if not runtime.active:
        return list(items)
    merged: List = []
    for blob in gather_bytes(runtime, pickle.dumps(list(items), protocol=4)):
        merged.extend(pickle.loads(blob))
    return merged


# ---------------------------------------------------------------------------
# Shard persistence + recovery: the task-retry analog.
#
# The reference inherits Spark's lineage-based task retry (SURVEY.md §5 /
# reference/README.md:66-88): a lost task re-executes from its
# immutable input. A process group cannot take a dead peer back inside a
# live job (collectives require every process), so recovery is
# relaunch-based, built on the same property Spark relies on — shards are
# deterministic functions of immutable inputs:
#
#  1. every process persists its computed shard records to
#     <out>.shards/shard-<i>-of-<n>.pkl (atomic rename) BEFORE entering
#     the merge, so completed work survives any peer's death;
#  2. a dead peer trips the watchdog — survivors exit 42 with their
#     shard files on disk;
#  3. `guacamole-torch <cmd> ... --recover` (single process) loads the
#     completed shard files, re-executes ONLY the missing shards' loci
#     (BAM + .bai pushdown make that cheap), merges, and writes output
#     byte-identical to an undisturbed run (pinned by
#     tests/test_torch_multihost.py::test_recover_after_killed_process).
# ---------------------------------------------------------------------------


def shard_dir(out_path: str) -> str:
    return out_path + ".shards"


def persist_shard(
    out_path: str, process_index: int, process_count: int, records
) -> None:
    """Atomically persist this process's computed shard records."""
    if not out_path:
        return
    d = shard_dir(out_path)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".tmp-{process_index}")
    with open(tmp, "wb") as fh:
        pickle.dump(
            {
                "process_index": process_index,
                "process_count": process_count,
                "records": list(records),
            },
            fh,
            protocol=4,
        )
    os.replace(
        tmp,
        os.path.join(
            d, f"shard-{process_index}-of-{process_count}.pkl"
        ),
    )


def load_shards(out_path: str):
    """(process_count, {process_index: records}) from a failed run's
    shard directory; (0, {}) when none exists. Shard files from a run
    with a DIFFERENT process count (stale leftovers from an earlier
    differently-sized failed job against the same --out) are ignored —
    mixing them would mis-split the loci axis. The trusted group is the
    one with the NEWEST file (mtime), i.e. the most recent failed run,
    regardless of whether it was larger or smaller than the stale one."""
    d = shard_dir(out_path)
    if not os.path.isdir(d):
        return 0, {}
    payloads = []  # (mtime, process_count, process_index, records)
    for name in sorted(os.listdir(d)):
        if not name.startswith("shard-") or not name.endswith(".pkl"):
            continue
        path = os.path.join(d, name)
        with open(path, "rb") as fh:
            p = pickle.load(fh)
        payloads.append(
            (
                os.path.getmtime(path),
                int(p["process_count"]),
                int(p["process_index"]),
                p["records"],
            )
        )
    if not payloads:
        return 0, {}
    count = max(payloads, key=lambda t: t[0])[1]  # newest file's count
    have: Dict[int, list] = {
        idx: records
        for _mt, cnt, idx, records in payloads
        if cnt == count
    }
    return count, have


def clear_shards(out_path: str) -> None:
    """Remove a run's shard directory (after a successful merge)."""
    import shutil

    shutil.rmtree(shard_dir(out_path), ignore_errors=True)


def missing_shards_expression(loci_set, process_count: int, have) -> str:
    """The loci expression covering every shard NOT in `have` (the work a
    --recover run re-executes), '' when nothing is missing. Shard
    boundaries are recomputed exactly as the original run's
    shard_loci_expression did (uniform split, deterministic)."""
    from guacamole_tpu_torch.loci.partition import partition_loci_uniformly

    partitions = partition_loci_uniformly(process_count, loci_set)
    inverse = partitions.inverse_map()
    parts = []
    for idx in range(process_count):
        if idx in have:
            continue
        shard = inverse.get(idx)
        if shard is None or shard.count == 0:
            continue
        for contig in shard.contigs:
            for start, end in shard.on_contig(contig).ranges:
                parts.append(f"{contig}:{start}-{end}")
    return ",".join(parts)


def barrier(runtime: MultihostRuntime, name: str) -> None:
    if not runtime.active:
        return
    import torch.distributed as dist

    with _dcn_watchdog(runtime, f"barrier/{name}"):
        try:
            dist.barrier()
        except (RuntimeError, OSError):
            _watchdog_abort(f"barrier/{name}", runtime.timeout_s)
