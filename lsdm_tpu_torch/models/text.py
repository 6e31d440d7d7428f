"""Text encoders of the port: the offline HASH encoder, and the resolver of
``--text_encoder auto``.

Counterpart of ``lsdm_tpu/models/text.py`` (``TextEncoder`` with
``encoder_type="HASH"`` and ``resolve_text_encoder``), in numpy.  HASH
embeds a hashed bag of words through a fixed random table: each lower-cased
word's SHA-1 picks a row of a seeded (4096, dim) table, and the prompt's
embedding is the mean of its rows.  It gives the JAX encoder's embeddings
bit for bit.  The CLIP and BERT towers (and the BPE tokenizer) are not
ported yet: ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

# the JAX package's vendored BPE merges asset (lsdm_tpu/models/text.py:
# CLIP_BPE_ASSET), read as a file: its presence decides "auto"
CLIP_BPE_ASSET = (Path(__file__).resolve().parents[2] / "lsdm_tpu" / "data"
                  / "assets" / "bpe_simple_vocab_16e6.txt.gz")
_NOT_PORTED = ("the {} text tower is not ported yet (ROADMAP.md queue 1 "
               "item 10): use --text_encoder HASH")


def resolve_clip_bpe(path: Optional[str] = None) -> Optional[str]:
    """A CLIP BPE merges source, found without network access, or None.
    Search order as in the JAX package: ``path`` (a merges file, or a
    directory holding ``merges.txt``), ``$LSDM_TPU_CLIP_BPE``, the vendored
    asset, then any CLIP model's ``merges.txt`` in the HuggingFace cache."""
    def as_file(p):
        if p and os.path.isdir(p):
            p = os.path.join(p, "merges.txt")
        return p if p and os.path.isfile(p) else None

    for candidate in (path, os.environ.get("LSDM_TPU_CLIP_BPE"),
                      str(CLIP_BPE_ASSET)):
        found = as_file(candidate)
        if found:
            return found
    hub = os.path.expanduser(os.environ.get("HF_HOME", "~/.cache/huggingface"))
    for root in (os.path.join(hub, "hub"), hub):
        if not os.path.isdir(root):
            continue
        for model_dir in sorted(os.listdir(root)):
            if "clip" not in model_dir.lower():
                continue
            for dirpath, _, files in os.walk(os.path.join(root, model_dir)):
                if "merges.txt" in files:
                    return os.path.join(dirpath, "merges.txt")
    return None


def resolve_text_encoder(requested: str, bpe_path: Optional[str] = None) -> str:
    """``"auto"`` -> "CLIP" when a BPE merges source exists, else "HASH";
    explicit choices pass through.  (In the port "CLIP" then raises.)"""
    if requested != "auto":
        return requested
    return "CLIP" if resolve_clip_bpe(bpe_path) else "HASH"


class TextEncoder:
    """list[str] -> (B, dim) float32 embeddings; ``encoder_type`` "HASH"
    (the others raise ``NotImplementedError``)."""

    def __init__(self, encoder_type: str = "HASH", dim: int = 512,
                 seed: int = 0):
        if encoder_type in ("CLIP", "BERT"):
            raise NotImplementedError(_NOT_PORTED.format(encoder_type))
        if encoder_type != "HASH":
            raise NotImplementedError(encoder_type)
        self.encoder_type = encoder_type
        self.dim = dim
        self.cache = {}
        rng = np.random.RandomState(seed)
        self._table = rng.randn(4096, dim).astype(np.float32) / np.sqrt(dim)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        for t in texts:
            if t not in self.cache:
                ids = [int.from_bytes(hashlib.sha1(w.encode()).digest()[:4],
                                      "little") % 4096
                       for w in t.lower().split()] or [0]
                self.cache[t] = self._table[ids].mean(0).astype(np.float32)
        return np.stack([self.cache[t] for t in texts]).astype(np.float32)
