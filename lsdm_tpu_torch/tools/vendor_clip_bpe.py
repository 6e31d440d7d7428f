"""Vendor the CLIP BPE merges table into the repo asset location.

The CLIP tokenizer's 48,894 learned merges are data, not code, and cannot
be made offline.  Run this once on a machine that has a CLIP copy (an HF
cache of any CLIP model, OpenAI's ``bpe_simple_vocab_16e6.txt.gz``, or an
explicit merges.txt):

    python -m lsdm_tpu_torch.tools.vendor_clip_bpe [--source PATH] [--force]

It writes ``lsdm_tpu/data/assets/bpe_simple_vocab_16e6.txt.gz`` and a
``.sha256`` pin of its content, which ``resolve_clip_bpe`` checks on every
later load; from then on ``--text_encoder CLIP`` (and the CLIs' ``auto``)
finds the merges with no flag.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=None,
                    help="merges file or directory (default: the resolution "
                         "chain: $LSDM_TPU_CLIP_BPE, any CLIP model in the HF "
                         "cache)")
    ap.add_argument("--dest", default=None,
                    help="another destination than the repo asset")
    ap.add_argument("--force", action="store_true",
                    help="vendor a non-canonical table anyway (NOT parity-grade)")
    args = ap.parse_args(argv)

    from lsdm_tpu_torch.models.text import vendor_clip_bpe

    try:
        info = vendor_clip_bpe(args.source, dest=args.dest, force=args.force)
    except (FileNotFoundError, ValueError) as e:
        print(f"vendor_clip_bpe: {e}", file=sys.stderr)
        return 2
    print(json.dumps(info, indent=2))
    if not info["parity_grade"]:
        print("WARNING: vendored table is NOT the canonical 48,894-merge CLIP "
              "table; embeddings will not match released checkpoints.",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
