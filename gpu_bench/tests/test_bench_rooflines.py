"""The rooflines' arithmetic against hand-counted tiles, and the spans'
self times and idle gaps on made-up events."""

import time

import numpy as np

import run as harness
import tracing


def _roofline(kernel):
    return {r.KERNEL: r for r in harness.rooflines()}[kernel]


def test_csr_count_screen_counts_the_live_blob():
    rl = _roofline("csr_count_screen")
    # Three rows of 3, 0 and 5 bytes of nibbles, K = 8, a padded blob.
    csr_nib = np.zeros(64, np.uint8)
    row_off = np.array([0, 3, 3, 8], np.int32)
    is_variant = np.zeros((3, 8), bool)
    n_bytes, n_ops = rl.work((csr_nib, row_off, is_variant, "cuda"), {})
    # 8 live bytes + 4 offsets x 4 B + 3 words x 2 B + 3 x 8 counts x 2 B
    # + 3 flags.
    assert n_bytes == 8 + 16 + 6 + 48 + 3
    assert n_ops == 16


def test_ll_screen_counts_valid_elements_of_live_rows():
    rl = _roofline("ll_screen")
    pack = np.full((4, 4), 0xFF, np.uint8)
    pack[0, :3] = 1  # live, 3 valid
    pack[1, :4] = 1  # no variant allele: not read
    pack[2, :2] = 1  # a variant allele that is not standard: not read
    pack[3, :1] = 1  # live, 1 valid
    iv = np.zeros((4, 8), bool)
    std = np.zeros((4, 8), bool)
    iv[[0, 2, 3], 1] = True
    std[[0, 3], 1] = True
    n_bytes, n_ops = rl.work((pack, None, iv, std, np.arange(4), "cuda"), {})
    assert n_bytes == 4 * 1 + 4 * 5 and n_ops == 8
    mapq = np.zeros((4, 4), np.uint8)
    n_bytes, _ = rl.work((pack, mapq, iv, std, np.arange(4), "cuda"), {})
    assert n_bytes == 4 * 2 + 4 * 5
    wide = pack.astype(np.uint16)
    wide[pack == 0xFF] = 0xFFFF
    n_bytes, _ = rl.work((wide, None, iv, std, None, "cuda"), {})
    assert n_bytes == 4 * 2 + 4 * 5


def test_a_launch_matched_to_its_kernel_gives_the_share():
    run = harness.RunData()
    run.roofline_work["k"] = [2, 0.5e-3]
    run.roofline_device_name["k"] = "k_kernel"
    run.kernel_n["k_kernel"] = 2
    run.kernel_s["k_kernel"] = 2e-3
    assert run.roofline("k") == 25.0
    run.kernel_n["k_kernel"] = 3  # a launch the wrapper did not see
    assert run.roofline("k") is None


def test_self_time_leaves_out_other_layers_and_counts_nesting_once():
    tr = tracing.Tracer()

    def inner():
        time.sleep(0.02)

    def outer():
        time.sleep(0.02)
        wrapped_inner()
        same()

    def same_body():
        time.sleep(0.01)

    wrapped_inner = tr.span("b", inner)
    same = tr.span("a", same_body)
    tr.span("a", outer)()
    assert 0.025 < tr.self_s["a"] < 0.05
    assert 0.015 < tr.self_s["b"] < 0.04
    assert [s[2] for s in tr.main] == ["b", "a"]


def test_gaps_are_named_by_the_main_thread_span():
    tr = tracing.Tracer()
    tr.main = [(0, 100, "pack"), (40, 60, "dispatch"), (100, 200, "confirm")]
    events = [(10, 20, "k1"), (30, 35, "k2"), (150, 160, "k1")]
    busy = tracing.union_intervals(events, 0, 200)
    assert busy == [(10, 20), (30, 35), (150, 160)]
    ops, idle = tracing.breakdown(events, busy, 0, 200, tr.name_at)
    assert dict(ops) == {"k1": 20e-9, "k2": 5e-9}
    # Gaps: 0-10 pack, 20-30 pack, 35-150 dispatch (middle at 92 -> pack),
    # 160-200 confirm.
    assert dict(idle) == {"pack": (10 + 10 + 115) * 1e-9,
                          "confirm": 40e-9}
