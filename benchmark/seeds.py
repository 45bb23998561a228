"""Seeds of a run's parts, derived from ``--seed`` (any whole number) and a
tag: the same pair always gives the same 63-bit seed."""

from __future__ import annotations

import hashlib


def derive(seed: int, tag: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
