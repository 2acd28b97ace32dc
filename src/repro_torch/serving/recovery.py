"""Retry, checkpoint and read-verification primitives (DESIGN.md §13).

Twin of ``src/repro/serving/recovery.py``: ``RetryPolicy`` (bounded
attempts, exponential backoff with deterministic jitter, deadline-aware
in the scheduler, ``failover`` gating the executor swap),
``LaneSnapshot`` / ``CheckpointStore`` (per-request host-side lane
snapshots) and ``verified_read`` (voted reads of the done mask).

Engine states are NamedTuples of tensors, so one snapshot routine serves
every engine.  ``CheckpointStore.put`` takes a host COPY of each leaf:
on the CPU ``x.cpu().numpy()`` shares memory with ``x``, and the lane
views it is handed are rows of pool buffers that later rounds overwrite.
``restore_state`` puts a snapshot back on a device as fresh tensors —
the device of the executor that installs it, which after a failover is
the new executor.  Everything here is OFF by default:
``MBEServer(retry=None)`` takes no extra branch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serving.faults import FaultError, u01


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How the scheduler responds to a failed round launch."""

    max_attempts: int = 3           # total tries per round (1 = no retry)
    backoff_s: float = 0.001        # base sleep before attempt 2
    backoff_mult: float = 2.0       # exponential growth per attempt
    max_backoff_s: float = 0.25     # backoff ceiling
    jitter: float = 0.5             # +- fraction of the base delay
    seed: int = 0                   # jitter schedule seed (deterministic)
    checkpoint_interval: int = 4    # polls between lane snapshots
    #                                 (0 = no checkpointing: failover
    #                                 restarts requests from scratch)
    failover: bool = True           # swap executors on DeviceLostError
    retry_on: tuple = (FaultError,)     # exception types worth retrying
    #                                 (not broadened: see serving.faults)

    def delay_s(self, site: str, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based count of failures so
        far) at ``site``, with deterministic jitter in
        ``[1 - jitter, 1 + jitter] x base``, seeded per (site, attempt)."""
        base = min(self.backoff_s * self.backoff_mult ** (attempt - 1),
                   self.max_backoff_s)
        u = u01(f"{self.seed}:{site}:{attempt}")
        return base * (1.0 - self.jitter + 2.0 * self.jitter * u)


@dataclasses.dataclass
class LaneSnapshot:
    """One lane's host-side checkpoint: the engine state with NumPy
    leaves (device-independent, restores onto ANY executor) plus the
    request's latency attribution at snapshot time."""

    state: object
    queue_s: float
    service_s: float
    compile_s: float


def snapshot_state(state):
    """Host copy of an engine state: every leaf a NumPy array that owns
    its memory (the word leaves stay int32 bit patterns)."""
    return type(state)(*[np.array(x.detach().cpu().numpy(), copy=True)
                         for x in state])


def restore_state(snap_state, device):
    """A snapshot's leaves as fresh tensors on ``device``."""
    return type(snap_state)(*[torch.tensor(x, device=device)
                              for x in snap_state])


class CheckpointStore:
    """Per-request lane snapshots, keyed by rid (so restoring can never
    resurrect a lane that was demuxed and refilled since: only the
    current occupant's own snapshot is offered back)."""

    def __init__(self):
        self._snaps: dict[int, LaneSnapshot] = {}
        self.taken = 0                  # monotonic snapshot count

    def put(self, rid: int, state, *, queue_s: float, service_s: float,
            compile_s: float) -> None:
        """Snapshot one lane as a host copy (a device checkpoint would
        die with its device; a view would follow later rounds)."""
        self._snaps[rid] = LaneSnapshot(
            state=snapshot_state(state), queue_s=queue_s,
            service_s=service_s, compile_s=compile_s)
        self.taken += 1

    def get(self, rid: int) -> LaneSnapshot | None:
        return self._snaps.get(rid)

    def pop(self, rid: int) -> LaneSnapshot | None:
        return self._snaps.pop(rid, None)

    def __len__(self) -> int:
        return len(self._snaps)

    def rids(self) -> list[int]:
        return sorted(self._snaps)


def verified_read(read, max_reads: int = 12, votes: int = 3):
    """Read until one VALUE has been returned ``votes`` times (in any
    positions); returns ``(value, mismatches)`` where ``mismatches``
    counts reads disagreeing with their predecessor (0 on the clean
    path, which costs ``votes`` reads).  After ``max_reads`` the modal
    value wins.  As in the reference, the vote is statistical and
    weakest on single-lane pools, where every corruption votes for the
    same impostor."""
    counts: dict[bytes, int] = {}
    first: dict[bytes, object] = {}
    prev_key = None
    mismatches = 0
    for _ in range(max_reads):
        cur = read()
        key = np.asarray(cur).tobytes()
        if prev_key is not None and key != prev_key:
            mismatches += 1
        prev_key = key
        counts[key] = counts.get(key, 0) + 1
        first.setdefault(key, cur)
        if counts[key] >= votes:
            return cur, mismatches
    modal = max(counts, key=lambda k: counts[k])
    return first[modal], mismatches
