"""Launch-geometry heuristics: input size -> scan/reduction blocking.

The analogue of the reference's static dispatch tables mapping input size
to (workgroup_size, x/y/z workgroup counts) per stage
(``src/cuzk/msm.rs:100-122`` decompose, ``:191-213`` SMVP, ``:266-271`` BPR).
Here the tunables are:

- ``num_rows``  — lane width R of the blocked prefix scan (more lanes = wider
  batches and a shorter sequential chain; the scan runs n/R steps)
- ``bpr_threads`` — lane width T of the blocked bucket reduction (block size
  Bl = (num_buckets-1)/T must be a power of two)
- ``subtask_batch`` — how many subtasks process concurrently (bounds peak
  device-memory working set, like the reference's 4-subtasks-per-SMVP-dispatch chunking
  at msm.rs:213)
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MsmGeometry:
    num_rows: int
    bpr_threads: int
    subtask_batch: int


def pick_geometry(n: int, chunk_size: int) -> MsmGeometry:
    """n must be a power of two (the host pads, like msm.rs:48-61).
    Not yet tuned on the H100: the constants below are carried over from
    the first hardware target."""
    assert n & (n - 1) == 0 and n > 0
    # scan lanes: wide enough to fill the device, small enough that the
    # row-offset prefix machinery (~2R projective adds) stays minor next
    # to the n-madd row scan
    num_rows = max(1, min(n // 8, 1 << 14))
    # bucket-reduction lanes (parity/naive paths only — production uses the
    # telescoped window_sum_from_pe): body = 2^(c-1) buckets in power-of-two
    # blocks
    body = 1 << (chunk_size - 1)
    bpr_threads = max(1, min(body // 16, 1 << 9))
    # concurrent subtasks per lax.map step (peak working set ~240n bytes
    # per subtask)
    subtask_batch = 4
    return MsmGeometry(num_rows, bpr_threads, subtask_batch)
