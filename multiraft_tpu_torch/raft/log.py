"""In-memory Raft log with snapshot rebase (reference: raft/raft_log.go).

Entry 0 is a dummy carrying ``(last_snapshot_index, last_snapshot_term)``
(reference: raft/raft_log.go:3-5); all absolute indices are translated
through the base (``convertIndex``, raft/raft_log.go:55-60).  This is the
Python mirror of the batched engine's fixed-capacity device ring +
``log_base`` arithmetic — same index algebra, dynamic storage.
"""

from __future__ import annotations

from typing import List, Optional

from .messages import Entry

__all__ = ["RaftLog"]


class RaftLog:
    def __init__(self, entries: Optional[List[Entry]] = None) -> None:
        # entries[0] is always the dummy: index = snapshot index,
        # term = snapshot term, command = None.
        self.entries: List[Entry] = entries or [Entry(index=0, term=0)]

    # -- bounds -----------------------------------------------------------

    @property
    def base(self) -> int:
        """Index of the dummy head == last snapshot index."""
        return self.entries[0].index

    @property
    def base_term(self) -> int:
        return self.entries[0].term

    @property
    def last_index(self) -> int:
        return self.entries[-1].index

    @property
    def last_term(self) -> int:
        return self.entries[-1].term

    def __len__(self) -> int:
        """Number of real entries (excluding the dummy)."""
        return len(self.entries) - 1

    # -- access -----------------------------------------------------------

    def _pos(self, index: int) -> int:
        """Absolute index → list position (convertIndex,
        reference: raft/raft_log.go:55-60)."""
        pos = index - self.base
        if pos < 0 or pos >= len(self.entries):
            raise IndexError(
                f"log index {index} out of range [base={self.base}, "
                f"last={self.last_index}]"
            )
        return pos

    def at(self, index: int) -> Entry:
        return self.entries[self._pos(index)]

    def term_at(self, index: int) -> int:
        return self.entries[self._pos(index)].term

    def has(self, index: int) -> bool:
        return self.base <= index <= self.last_index

    def slice_from(self, index: int) -> List[Entry]:
        """Entries with absolute index ≥ ``index``
        (reference: raft/raft_log.go sliceFrom)."""
        return self.entries[self._pos(index):] if index <= self.last_index else []

    # -- mutation ---------------------------------------------------------

    def append(self, entry: Entry) -> None:
        entry.index = self.last_index + 1
        # The replicated log grows by design; snapshot compaction
        # (compact_to, driven by maxraftstate) is what bounds it.
        self.entries.append(entry)  # graftlint: disable=unbounded-queue

    def truncate_from(self, index: int) -> None:
        """Drop entries with absolute index ≥ ``index``
        (reference: raft/raft_log.go trunc)."""
        del self.entries[self._pos(index):]

    def compact_to(self, index: int, term: Optional[int] = None) -> None:
        """Discard entries ≤ ``index``, installing a new dummy head —
        snapshot rebase (reference: raft/raft_snapshot.go:10-12).

        If ``index`` is beyond the log (InstallSnapshot ahead of us),
        ``term`` supplies the dummy's term and the log empties."""
        if index <= self.base:
            return
        if self.has(index):
            keep = self.entries[self._pos(index):]
            keep[0] = Entry(index=index, term=keep[0].term, command=None)
            self.entries = keep
        else:
            assert term is not None, "compact beyond log needs explicit term"
            self.entries = [Entry(index=index, term=term, command=None)]

    # -- predicates -------------------------------------------------------

    def matches(self, prev_index: int, prev_term: int) -> bool:
        """Does the log contain ``prev_index`` with ``prev_term``?
        (reference: raft/raft_log.go:92-96)"""
        return self.has(prev_index) and self.term_at(prev_index) == prev_term

    def up_to_date(self, last_index: int, last_term: int) -> bool:
        """Election restriction (reference: raft/raft_log.go:99-104):
        candidate's log is at least as up-to-date as ours."""
        if last_term != self.last_term:
            return last_term > self.last_term
        return last_index >= self.last_index

    def first_index_of_term(self, term: int, from_index: int) -> int:
        """Scan back from ``from_index`` to the first entry of ``term`` —
        the conflict fast-backup scan
        (reference: raft/raft_append_entry.go:136-143)."""
        i = from_index
        while i - 1 > self.base and self.term_at(i - 1) == term:
            i -= 1
        return i
