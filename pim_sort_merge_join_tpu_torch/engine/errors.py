"""Structured engine errors.

The reference's only failure handling is `DPU_ASSERT` -> abort plus
post-mortem fault introspection (dpu_error.h, dpu_debug.h, SURVEY.md
section 5 "Failure detection"). The engine replaces that with typed
exceptions carrying enough state to diagnose and re-run.
"""

from __future__ import annotations


class EngineError(Exception):
    """Base class for engine failures."""


class CapacityError(EngineError):
    """A fixed-capacity buffer was too small for the data routed to it."""


class ExchangeOverflowError(CapacityError):
    """An all_to_all exchange dropped rows: a shard received more rows than
    its receive capacity (usually key skew beyond `exchange_slack`).

    Remedies: raise `EngineConfig.exchange_slack`, raise
    `splitter_sample`, or enable heavy-hitter handling.
    """

    def __init__(self, table: str, true_rows, capacity: int):
        self.table = table
        self.true_rows = list(map(int, true_rows))
        self.capacity = int(capacity)
        overfull = [
            (i, t) for i, t in enumerate(self.true_rows) if t > self.capacity
        ]
        super().__init__(
            f"exchange overflow on {table}: shards {overfull} received more "
            f"rows than receive capacity {self.capacity}; increase "
            f"exchange_slack or splitter_sample"
        )


class JoinOverflowError(CapacityError):
    """An inner join produced more rows than the output capacity."""

    def __init__(self, true_rows: int, capacity: int):
        self.true_rows = int(true_rows)
        self.capacity = int(capacity)
        super().__init__(
            f"join output overflow: {self.true_rows} result rows > capacity "
            f"{self.capacity}; increase join_slack"
        )


class MalformedInputError(EngineError):
    """Input CSV does not match its declared schema."""
