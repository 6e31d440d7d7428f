"""Seeds derived from the run's ``--seed``: one stream a purpose and index,
so that a request's inputs do not depend on how many came before it."""

from __future__ import annotations

import zlib

import numpy as np


def sub_seed(seed: int, purpose: str, *index: int) -> int:
    """A 63-bit seed for ``purpose`` (and ``index``) under ``seed``, which
    may be any whole number that fits in 64 bits."""
    words = [int(seed) & (2 ** 64 - 1), zlib.crc32(purpose.encode())]
    words += [int(i) & (2 ** 64 - 1) for i in index]
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
