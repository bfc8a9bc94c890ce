"""Conflict-DAG transaction dispatcher — the replay parallelism core
(copy of `ConflictDag` of the JAX package's replay/rdisp.py:53, with its
dispatcher and wave modes; the fork-aware `StagedDispatcher` comes with
replay, ROADMAP.md queue A item 5).

Re-expression of the reference's rdisp
(ref: src/discof/replay/fd_rdisp.h:6-80 — account r/w conflict DAG with
the *serial fiction* guarantee).

Two consumption modes over one DAG:

  * **Dispatcher mode** (`next_ready` / `complete`): hand out any txn
    whose predecessors have all completed, preserving the serial
    fiction: the observable state after the block equals executing txns
    in insertion order.
  * **Wave mode** (`waves()`): topological levels of the DAG. All txns
    in a wave are pairwise conflict-free, so a wave executes as one
    step of the wave-scan kernel (svm/executor.py, csrc/wave_scan.cu),
    one thread a lane.

Conflict rule (same as the reference's): two transactions conflict iff
one WRITES an account the other reads or writes. Edges are added
insertion-order only (i -> j with i < j), so the DAG is acyclic by
construction and any topological execution is serial-fiction-correct.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class TxnState(enum.Enum):
    PENDING = 0      # has unfinished predecessors
    READY = 1        # all predecessors complete, not yet handed out
    DISPATCHED = 2   # handed to an executor
    DONE = 3


@dataclass
class _Txn:
    idx: int
    writes: tuple
    reads: tuple
    preds_left: int = 0
    succs: list = field(default_factory=list)
    state: TxnState = TxnState.PENDING


class ConflictDag:
    """One staging lane: insertion-ordered account-conflict DAG."""

    def __init__(self):
        self._txns: list[_Txn] = []
        # per-account trackers (insertion-order maintenance):
        #   last_writer[acct] = txn idx of most recent writer
        #   readers_since[acct] = txns that read acct after that write
        self._last_writer: dict = {}
        self._readers_since: dict = {}
        self._ready: list[int] = []
        self._done_cnt = 0

    def __len__(self):
        return len(self._txns)

    @property
    def done(self) -> bool:
        return self._done_cnt == len(self._txns)

    def add_txn(self, writes, reads) -> int:
        """Insert the next txn (insertion order = serial order). writes /
        reads: iterables of hashable account keys. Returns txn index."""
        idx = len(self._txns)
        t = _Txn(idx, tuple(writes), tuple(reads))
        wset = set(t.writes)
        preds = set()
        for a in t.writes:
            # W/W with last writer, W/R with every reader since that write
            lw = self._last_writer.get(a)
            if lw is not None:
                preds.add(lw)
            preds.update(self._readers_since.get(a, ()))
        for a in t.reads:
            if a in wset:
                continue
            lw = self._last_writer.get(a)          # R/W with last writer
            if lw is not None:
                preds.add(lw)
        preds.discard(idx)
        live = [p for p in preds
                if self._txns[p].state is not TxnState.DONE]
        t.preds_left = len(live)
        for p in live:
            self._txns[p].succs.append(idx)
        self._txns.append(t)
        # update trackers AFTER edge construction
        for a in t.writes:
            self._last_writer[a] = idx
            self._readers_since[a] = set()
        for a in t.reads:
            if a not in wset:
                self._readers_since.setdefault(a, set()).add(idx)
        if t.preds_left == 0:
            t.state = TxnState.READY
            self._ready.append(idx)
        return idx

    # -- dispatcher mode ----------------------------------------------------

    def next_ready(self) -> int | None:
        """Pop any READY txn (lowest index first — matches the reference's
        bias toward serial order for cache warmth)."""
        while self._ready:
            idx = self._ready.pop(0)
            t = self._txns[idx]
            if t.state is TxnState.READY:
                t.state = TxnState.DISPATCHED
                return idx
        return None

    def complete(self, idx: int):
        """Mark a dispatched txn executed; unlock successors."""
        t = self._txns[idx]
        assert t.state is TxnState.DISPATCHED, (idx, t.state)
        t.state = TxnState.DONE
        self._done_cnt += 1
        for s in t.succs:
            st = self._txns[s]
            st.preds_left -= 1
            if st.preds_left == 0 and st.state is TxnState.PENDING:
                st.state = TxnState.READY
                self._ready.append(s)

    # -- wave mode ------------------------------------------------------------

    def waves(self) -> list[list[int]]:
        """Topological levels over the full DAG (ignores dispatch state).
        level(t) = 1 + max(level(pred)); txns in one level are pairwise
        conflict-free. Executing levels in order with any intra-level
        order preserves the serial fiction."""
        level = [0] * len(self._txns)
        for t in self._txns:                 # succs always have larger idx
            for s in t.succs:
                if level[s] < level[t.idx] + 1:
                    level[s] = level[t.idx] + 1
        out: list[list[int]] = []
        for i, lv in enumerate(level):
            while len(out) <= lv:
                out.append([])
            out[lv].append(i)
        return out
