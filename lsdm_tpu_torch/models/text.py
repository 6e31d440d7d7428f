"""Frozen text encoders of the conditioning pathway.

Counterpart of ``lsdm_tpu/models/text.py``.  The reference embeds prompts
with a frozen CLIP ViT-B/32 text tower (or BERT-base) inside the denoiser
forward (``model/sdm.py:245-285``); as in the JAX package the frozen tower
runs once per prompt, outside the denoiser, and its embeddings are cached:

  * :class:`CLIPTextTransformer` — the CLIP text tower (vocab 49408,
    context 77, width 512, 12 layers, causal attention, EOT pooling and
    the text projection), parameters named as OpenAI's ``clip`` package
    names them, so a reference state dict loads with ``load_state_dict``
    (:func:`lsdm_tpu_torch.weights.clip_text_state_dict` takes the HF
    naming too).
  * :class:`SimpleTokenizer` — CLIP's BPE over a merges file, its word
    split a scanner over ``unicodedata`` categories (the stdlib ``re``
    has no ``\\p{L}``/``\\p{N}``) that gives the JAX tokenizer's ids.
  * :class:`HashTokenizer` — the offline stand-in: ids from word hashes.
  * :class:`TextEncoder` — list[str] -> (B, dim) float32 with the
    reference's pad-to-77 scheme; "CLIP", "BERT"
    (:mod:`lsdm_tpu_torch.models.bert`), "HASH" or "CACHED".

The merges are learned data that the repo does not ship: they are found by
:func:`resolve_clip_bpe` and pinned into the repo by :func:`vendor_clip_bpe`
(``python -m lsdm_tpu_torch.tools.vendor_clip_bpe``).
"""

from __future__ import annotations

import gzip
import hashlib
import math
import os
import unicodedata
import warnings
from pathlib import Path
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.ops.attention import multihead_attention

#: the repo's location of the CLIP BPE asset (the JAX package's data file,
#: read and written by path; not shipped, see :func:`vendor_clip_bpe`)
CLIP_BPE_ASSET = str(Path(__file__).resolve().parents[2] / "lsdm_tpu" / "data"
                     / "assets" / "bpe_simple_vocab_16e6.txt.gz")

#: how to provide the asset, shown in warnings and errors
CLIP_BPE_HELP = (
    "Provide the CLIP BPE merges via --bpe_path (the OpenAI "
    "bpe_simple_vocab_16e6.txt.gz, an HF merges.txt, or a directory/HF "
    "snapshot containing merges.txt), set $LSDM_TPU_CLIP_BPE, or place the "
    f"file at {CLIP_BPE_ASSET}. An HF cache of any CLIP model "
    "(~/.cache/huggingface) is also auto-detected."
)

#: merge count of the canonical CLIP table (49408-token vocab = 2*256
#: byte symbols + 48894 merges + 2 specials)
CLIP_CANONICAL_MERGES = 48894


class CLIPAttention(nn.Module):
    """Causal self-attention with one (3E, E) input projection split into
    q, k and v, as ``torch.nn.MultiheadAttention`` stores it."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        out, _ = multihead_attention(q, k, v, self.heads, attn_mask=mask,
                                     need_weights=False)
        return self.out_proj(out)


class _QuickGELUMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))  # CLIP's QuickGELU


class CLIPResidualBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then x + mlp(ln_2(x))."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _QuickGELUMLP(width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPResidualBlock(width, heads)
                                       for _ in range(layers))


class CLIPTextTransformer(nn.Module):
    """CLIP ViT-B/32 text tower (JAX ``CLIPTextTransformer``): tokens
    (B, context_length) int64 -> (B, embed_dim)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, heads: int = 8, layers: int = 12,
                 embed_dim: int = 512):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = _Transformer(width, heads, layers)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))
        L = context_length
        self.register_buffer("causal_mask", torch.triu(
            torch.full((L, L), float("-inf")), diagonal=1), persistent=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(tokens) + self.positional_embedding
        for block in self.transformer.resblocks:
            x = block(x, self.causal_mask)
        x = self.ln_final(x)
        # pool at the EOT token (the highest id), then project
        eot = tokens.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection


def _trunc_normal(shape, std: float, g: torch.Generator) -> torch.Tensor:
    """N(0, std^2) truncated to two standard deviations, by inverse CDF."""
    lo = 0.5 * math.erfc(2 / math.sqrt(2))
    u = torch.rand(shape, generator=g, dtype=torch.float64) * (1 - 2 * lo) + lo
    return (torch.erfinv(2 * u - 1) * math.sqrt(2) * std).float()


@torch.no_grad()
def init_clip_weights(model: CLIPTextTransformer, seed: int) -> CLIPTextTransformer:
    """Fill the tower from one seeded generator with the JAX tower's
    distributions (not its draws): token embedding N(0, 0.02^2),
    positional N(0, 0.01^2), in-projection Xavier-uniform, linear weights
    flax's ``lecun_normal`` over the (out, in) layout (truncated normal of
    variance 1/out), zero biases, unit LayerNorms, projection
    N(0, 1/width)."""
    g = torch.Generator().manual_seed(seed)
    width = model.positional_embedding.shape[1]
    model.token_embedding.weight.copy_(
        torch.randn(model.token_embedding.weight.shape, generator=g) * 0.02)
    model.positional_embedding.copy_(
        torch.randn(model.positional_embedding.shape, generator=g) * 0.01)
    for m in model.modules():
        if isinstance(m, CLIPAttention):
            w = m.in_proj_weight
            bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) * bound)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.Linear):
            # truncated normal's std is 0.8796 of the untruncated one
            m.weight.copy_(_trunc_normal(m.weight.shape, m.weight.shape[0] ** -0.5
                                         / 0.87962566103423978, g))
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    model.text_projection.copy_(
        torch.randn(model.text_projection.shape, generator=g) * width ** -0.5)
    return model


def bytes_to_unicode():
    """CLIP/GPT-2 byte <-> unicode table (standard public scheme)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _read_merges_text(path: str) -> str:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read().decode("utf-8")


def _verify_asset_hash(asset_path: str) -> None:
    """Where a ``.sha256`` sidecar exists (written by
    :func:`vendor_clip_bpe`), hold the asset's uncompressed content to it:
    a corrupt or swapped asset raises instead of tokenizing wrong."""
    sidecar = asset_path + ".sha256"
    if not os.path.isfile(sidecar):
        return
    with open(sidecar) as f:
        expected = f.read().split()[0].strip()
    actual = hashlib.sha256(_read_merges_text(asset_path).encode("utf-8")).hexdigest()
    if actual != expected:
        raise RuntimeError(
            f"CLIP BPE asset {asset_path} does not match its pinned "
            f"content hash ({actual} != {expected}). Re-vendor it with "
            "python -m lsdm_tpu_torch.tools.vendor_clip_bpe or delete the "
            "stale asset.")


def resolve_clip_bpe(path: Optional[str] = None) -> Optional[str]:
    """A CLIP BPE merges source, found without network access, or None.

    Search order: ``path`` (a merges file, or a directory holding
    ``merges.txt``), ``$LSDM_TPU_CLIP_BPE``, the repo asset
    (:data:`CLIP_BPE_ASSET`, held to its vendoring sidecar's hash), then any
    CLIP model's ``merges.txt`` in the HuggingFace cache.  HF merges files
    carry the same 48,894 merges as OpenAI's gz, so either is parity-grade.
    """
    def as_file(p):
        if p and os.path.isdir(p):
            p = os.path.join(p, "merges.txt")
        return p if p and os.path.isfile(p) else None

    for candidate in (path, os.environ.get("LSDM_TPU_CLIP_BPE")):
        found = as_file(candidate)
        if found:
            return found
    asset = as_file(CLIP_BPE_ASSET)
    if asset:
        _verify_asset_hash(asset)
        return asset
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


def vendor_clip_bpe(source: Optional[str] = None, dest: Optional[str] = None,
                    force: bool = False) -> dict:
    """Copy a CLIP BPE merges source into the repo asset location, gzipped,
    with a ``.sha256`` sidecar of the uncompressed text that
    :func:`resolve_clip_bpe` checks on every later load.

    ``source``: an explicit merges file or directory; by default the
    resolution chain (env var, HF cache).  Refuses a table that is not the
    canonical 48,894 CLIP merges unless ``force``: a truncated or foreign
    table silently changes the tokens of any prompt it touches.
    """
    dest = dest or CLIP_BPE_ASSET
    if source is not None:
        # an explicit source must resolve to itself, never fall through to
        # the chain (which would pin another file than the one named)
        candidate = (os.path.join(source, "merges.txt")
                     if os.path.isdir(source) else source)
        if not os.path.isfile(candidate):
            raise FileNotFoundError(
                f"--source {source} is not a merges file (or a directory "
                "holding merges.txt)")
        found = candidate
    else:
        found = resolve_clip_bpe(None)
    if found is None:
        raise FileNotFoundError(
            "no CLIP BPE merges source found to vendor. " + CLIP_BPE_HELP)
    if os.path.abspath(found) == os.path.abspath(dest):
        raise FileNotFoundError(
            "only the already-vendored asset itself was found; pass an "
            "explicit source to re-vendor. " + CLIP_BPE_HELP)
    text = _read_merges_text(found)
    # the slice of the table CLIP's tokenizer reads; its content is checked
    # too, since an oversized foreign table (GPT-2's 50k byte-BPE merges,
    # with Ġ space markers and no </w>) slices down to the canonical count
    merges = [line for line in text.split("\n")[1:49152 - 256 - 2 + 1]
              if line.strip()]
    n_merges = len(merges)
    wellformed = all(len(line.split()) == 2 for line in merges)
    foreign = any("Ġ" in line for line in merges)
    endw = sum(1 for line in merges if line.rstrip().endswith("</w>"))
    clip_shaped = wellformed and not foreign and endw >= max(1, n_merges // 20)
    parity_grade = n_merges == CLIP_CANONICAL_MERGES and clip_shaped
    if not parity_grade and not force:
        why = (f"holds {n_merges} merges, not the canonical "
               f"{CLIP_CANONICAL_MERGES}" if n_merges != CLIP_CANONICAL_MERGES
               else "does not look like a CLIP merges table "
                    f"(wellformed={wellformed}, foreign-markers={foreign}, "
                    f"</w>-lines={endw})")
        raise ValueError(
            f"{found} {why} — a wrong/truncated table changes "
            "tokenization. Pass force=True (--force) to vendor anyway "
            "(NOT parity-grade).")
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    with gzip.open(dest, "wb") as f:
        f.write(text.encode("utf-8"))
    digest = hashlib.sha256(text.encode("utf-8")).hexdigest()
    with open(dest + ".sha256", "w") as f:
        f.write(f"{digest}  {os.path.basename(dest)} "
                f"(merges={n_merges}, source={found})\n")
    return {"source": found, "dest": dest, "sha256": digest,
            "merges": n_merges, "parity_grade": parity_grade}


def resolve_text_encoder(requested: str, bpe_path: Optional[str] = None) -> str:
    """The CLIs' ``--text_encoder auto``: "CLIP" when a BPE merges source
    can be found, else the offline "HASH"; explicit choices pass through."""
    if requested != "auto":
        return requested
    return "CLIP" if resolve_clip_bpe(bpe_path) else "HASH"


_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _folds_to(s: str, word: str) -> bool:
    # the JAX pattern matches its literals ignoring case; on lower-cased
    # text the one other character that folds onto them is the long s
    return s.replace("ſ", "s") == word


def _char_class(c: str) -> str:
    """"L", "N", "O" (other), or " " for a character no alternative takes."""
    cat = unicodedata.category(c)[0]
    if cat in "LN":
        return cat
    if c.isspace():
        return " "
    # ignoring case, the pattern's negated class also leaves out a
    # non-letter whose case forms are letters (U+0345 folds onto ι), and
    # its letter class does not take it either: findall skips it
    if any(unicodedata.category(x)[0] in "LN" for x in c.casefold() + c.upper() + c.lower()):
        return " "
    return "O"


def _split_words(text: str) -> List[str]:
    """The words of ``text`` as the JAX tokenizer's pattern finds them:
    ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|
    [\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (``regex``, ignoring case), tried in that
    order at each position, whitespace skipped.  ``\\p{L}``/``\\p{N}`` are
    the Unicode general categories L*/N* (so "²", "½" and "Ⅻ" are numbers,
    one a word, which ``[^\\W\\d_]`` would take for letters)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        for lit in _SPECIALS + _CONTRACTIONS:
            if _folds_to(text[i:i + len(lit)], lit):
                out.append(text[i:i + len(lit)])
                i += len(lit)
                break
        else:
            kind = _char_class(text[i])
            j = i + 1
            if kind == " ":
                i = j
                continue
            if kind != "N":  # a run of letters, or of other characters
                while j < n and _char_class(text[j]) == kind:
                    j += 1
            out.append(text[i:j])
            i = j
    return out


class SimpleTokenizer:
    """CLIP BPE tokenizer over a merges list: OpenAI's gzipped
    ``bpe_simple_vocab_16e6.txt.gz`` or an HF ``merges.txt`` (the same
    merges; both start with a header line).  Like the JAX tokenizer it
    lower-cases and joins whitespace, and runs no ftfy or HTML unescape."""

    def __init__(self, bpe_path: str):
        merges = _read_merges_text(bpe_path).split("\n")[1:49152 - 256 - 2 + 1]
        # drop blank tails (files smaller than the canonical 48894 merges)
        merges = [tuple(m.split()) for m in merges if m.strip()]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += list(_SPECIALS)
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {s: s for s in _SPECIALS}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _split_words(" ".join(text.lower().strip().split())):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    @property
    def sot(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot(self) -> int:
        return self.encoder["<|endoftext|>"]


class HashTokenizer:
    """Offline stand-in tokenizer: stable ids from word hashes (not
    CLIP-compatible, flagged wherever it stands in for one)."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        # the two highest ids are SOT/EOT, as in CLIP
        self._eot = vocab_size - 1
        self._sot = vocab_size - 2

    def encode(self, text: str) -> List[int]:
        return [int.from_bytes(hashlib.sha1(w.encode("utf-8")).digest()[:4],
                               "little") % (self.vocab_size - 2)
                for w in text.lower().strip().split()]

    @property
    def sot(self) -> int:
        return self._sot

    @property
    def eot(self) -> int:
        return self._eot


def tokenize_batch(tokenizer, texts: Sequence[str], context_length: int = 22,
                   pad_to: int = 77) -> np.ndarray:
    """The reference's tokens (``model/sdm.py:248-255``): [SOT] + the first
    ``context_length - 2`` tokens + [EOT], zero-padded to ``pad_to``;
    (B, pad_to) int64."""
    out = np.zeros((len(texts), pad_to), np.int64)
    for i, t in enumerate(texts):
        toks = [tokenizer.sot] + tokenizer.encode(t)[:context_length - 2] + [tokenizer.eot]
        out[i, :len(toks)] = toks
    return out


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("TextEncoder: no CUDA device; pass device='cpu' "
                           "to run the tower on the CPU")
    return dev


class TextEncoder:
    """list[str] -> (B, dim) float32 embeddings, cached per prompt.

    encoder_type:
      * "CLIP": the CLIP tower, weights from ``state_dict`` (the port's
        naming, :func:`lsdm_tpu_torch.weights.clip_text_state_dict`) or the
        seeded :func:`init_clip_weights`; tokens from the BPE merges that
        :func:`resolve_clip_bpe` finds, else (warned) the hash tokenizer,
        and with ``require_parity`` a ``RuntimeError`` instead.
      * "BERT": BERT-base's pooler output
        (:func:`lsdm_tpu_torch.models.bert.load_bert`), projected to
        ``dim`` by a seeded random matrix when ``dim`` is not its width
        (768).
      * "HASH": a hashed bag of words through a fixed random table
        (offline; the JAX encoder's embeddings bit for bit).
      * "CACHED": embeddings looked up in ``cache``.

    The towers run on ``device`` (a CUDA device unless the caller asks for
    the CPU) and stay there.
    """

    def __init__(self, encoder_type: str = "CLIP", dim: int = 512,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 bpe_path: Optional[str] = None, cache: Optional[dict] = None,
                 seed: int = 0, require_parity: bool = False, device="cuda"):
        self.encoder_type = encoder_type
        self.dim = dim
        self.cache = cache or {}
        if encoder_type == "CLIP":
            resolved = resolve_clip_bpe(bpe_path)
            if resolved:
                self.tokenizer = SimpleTokenizer(resolved)
            elif require_parity:
                raise RuntimeError(
                    "CLIP text encoder requested for a parity-grade "
                    "evaluation but no BPE merges asset was found. "
                    + CLIP_BPE_HELP)
            else:
                warnings.warn(
                    "CLIP text encoder requested without a BPE merges "
                    "source: falling back to the hash tokenizer. "
                    "Embeddings will NOT match released checkpoints. "
                    + CLIP_BPE_HELP, stacklevel=2)
                self.tokenizer = HashTokenizer()
            self.device = _device(device)
            self.model = CLIPTextTransformer(embed_dim=dim)
            if state_dict is None:
                init_clip_weights(self.model, seed)
            else:
                self.model.load_state_dict(state_dict)
            self.model.to(self.device).eval()
        elif encoder_type == "BERT":
            from lsdm_tpu_torch.models.bert import load_bert

            # reference alternative (model/sdm.py:261-285): the frozen
            # BERT-base pooler output
            self.model, self.tokenizer = load_bert(seed, require_parity)
            self.device = _device(device)
            self.model.to(self.device).eval()
            self._bert_proj = None
            hidden = self.model.cfg.hidden_size  # 768 for BERT-base
            if dim != hidden:
                rng = np.random.RandomState(seed)
                self._bert_proj = (rng.randn(hidden, dim).astype(np.float32)
                                   / np.sqrt(hidden))
        elif encoder_type == "HASH":
            rng = np.random.RandomState(seed)
            self._table = rng.randn(4096, dim).astype(np.float32) / np.sqrt(dim)
        elif encoder_type != "CACHED":
            raise NotImplementedError(encoder_type)

    @torch.no_grad()
    def _embed(self, texts: List[str]) -> np.ndarray:
        if self.encoder_type == "CLIP":
            toks = torch.from_numpy(tokenize_batch(self.tokenizer, texts))
            return self.model(toks.to(self.device)).cpu().numpy()
        if self.encoder_type == "BERT":
            from lsdm_tpu_torch.models.bert import WordPieceTokenizer

            if isinstance(self.tokenizer, WordPieceTokenizer):
                ids, mask = self.tokenizer.batch(texts, max_length=32)
            else:
                ids = tokenize_batch(self.tokenizer, texts, 20, 32)
                mask = (ids > 0).astype(np.int64)
            pooled = self.model(torch.from_numpy(ids).to(self.device),
                                torch.from_numpy(mask).to(self.device)).cpu().numpy()
            return pooled if self._bert_proj is None else pooled @ self._bert_proj
        embs = np.zeros((len(texts), self.dim), np.float32)  # HASH
        for i, t in enumerate(texts):
            ids = [int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
                   % 4096 for w in t.lower().split()] or [0]
            embs[i] = self._table[ids].mean(0)
        return embs

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if self.encoder_type != "CACHED":
            uncached = list(dict.fromkeys(t for t in texts if t not in self.cache))
            if uncached:
                for t, e in zip(uncached, self._embed(uncached)):
                    self.cache[t] = np.asarray(e, np.float32)
        return np.stack([self.cache[t] for t in texts]).astype(np.float32)
