"""Seeds of the benchmark's random streams, derived from ``--seed``.

Every stream (a table pair, the window's parameters, the warm-up's, the
sample of checked queries) has a seed of its own, a hash of the run's seed
and the stream's name, so adding a stream changes no other. Any whole
number is a valid run seed, of any size or sign.
"""

from __future__ import annotations

import hashlib


def derive(seed: int, *stream) -> int:
    """A 63-bit seed for the stream named by ``stream`` under ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(stream)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
