"""Independent sub-seeds derived from the run's ``--seed``.

A ``--seed`` may exceed 32 bits, so every consumer takes a sub-seed made
by hashing the run's seed with a tag: a 63-bit one for ``torch.Generator``,
a 32-bit one where numpy's ``RandomState`` (the port's splits) takes it.
"""

from __future__ import annotations

import hashlib


def sub_seed(seed: int, tag: str, bits: int = 63) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") % (1 << bits)
