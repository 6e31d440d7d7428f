"""BERT-base text tower and its WordPiece tokenizer.

The reference's alternative text encoder (``model/sdm.py:261-285``) is the
frozen ``bert-base-uncased`` pooler output; the JAX package runs it as
``transformers.FlaxBertModel``.  The port writes the tower and the
tokenizer itself, so that it needs no ``transformers``:

  * :class:`BertModel` — embeddings (word + token type 0 + position, then
    LayerNorm eps 1e-12), post-LN layers with the exact erf GELU, an
    additive attention bias of float32's lowest value on padded keys (as
    Flax BERT builds it from ``attention_mask``), and the pooler (dense
    then tanh on token 0).  Parameters are named as HF's torch
    ``BertModel`` names them (:func:`lsdm_tpu_torch.weights.bert_state_dict`
    turns a checkpoint of either HF naming into them).
  * :class:`WordPieceTokenizer` — the uncased ``BertTokenizerFast``:
    clean, split off CJK characters, strip accents (NFD, drop Mn),
    lower-case, split on whitespace and punctuation, greedy longest match
    with ``##`` continuations; ``[CLS] ... [SEP]`` and zero padding.
  * :func:`load_bert` — the pretrained tower from a local
    ``bert-base-uncased`` snapshot in the HF cache, else (warned) a seeded
    random tower with the hash tokenizer, as the JAX encoder falls back.
"""

from __future__ import annotations

import dataclasses
import json
import os
import unicodedata
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from lsdm_tpu_torch.ops.attention import multihead_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT-base by default (``transformers.BertConfig``'s defaults)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    @classmethod
    def from_json(cls, path: str) -> "BertConfig":
        with open(path) as f:
            cfg = json.load(f)
        return cls(**{k.name: cfg[k.name] for k in dataclasses.fields(cls)
                      if k.name in cfg})


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        # token type 0 everywhere; Flax BERT's order of the sum
        x = (self.word_embeddings(ids) + self.token_type_embeddings.weight[0]
             + self.position_embeddings(pos))
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        E = cfg.hidden_size
        self.query, self.key, self.value = nn.Linear(E, E), nn.Linear(E, E), nn.Linear(E, E)


class _DenseLN(nn.Module):
    def __init__(self, d_in: int, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(h) + residual)


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.self = _SelfAttention(cfg)
        self.output = _DenseLN(cfg.hidden_size, cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        s = self.self
        out, _ = multihead_attention(s.query(x), s.key(x), s.value(x), self.heads,
                                     attn_mask=bias, need_weights=False)
        return self.output(out, x)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))  # exact erf GELU


class _Layer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseLN(cfg.intermediate_size, cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_hidden_layers))


class _Pooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)


class BertModel(nn.Module):
    """(ids (B, S) int64, attention_mask (B, S)) -> pooler output (B, hidden)."""

    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.pooler = _Pooler(cfg)

    def forward(self, ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        B, S = ids.shape
        H = self.cfg.num_attention_heads
        # Flax BERT's bias: 0 on kept keys, float32's lowest value on padding
        bias = torch.where(attention_mask > 0, 0.0, torch.finfo(torch.float32).min)
        bias = bias[:, None, None, :].expand(B, H, S, S).reshape(B * H, S, S)
        x = self.embeddings(ids)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return torch.tanh(self.pooler.dense(x[:, 0]))


@torch.no_grad()
def init_bert_weights(model: BertModel, seed: int) -> BertModel:
    """Fill the tower from one seeded generator with Flax BERT's
    distributions (not its draws): embeddings and dense kernels
    N(0, initializer_range^2), zero biases, unit LayerNorms."""
    g = torch.Generator().manual_seed(seed)
    std = model.cfg.initializer_range
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * std)
            if isinstance(m, nn.Linear):
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


def _is_punctuation(c: str) -> bool:
    cp = ord(c)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(c).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    """The uncased BERT tokenizer over a ``vocab.txt`` (one token a line,
    the line number its id)."""

    def __init__(self, vocab_path: str, max_chars_per_word: int = 100):
        with open(vocab_path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(tokens) if t}
        self.max_chars_per_word = max_chars_per_word
        self.cls, self.sep = self.vocab["[CLS]"], self.vocab["[SEP]"]
        self.unk, self.pad = self.vocab["[UNK]"], self.vocab.get("[PAD]", 0)

    @staticmethod
    def normalize(text: str) -> str:
        out = []
        for c in text:
            cp = ord(c)
            # Unicode White_Space (str.isspace also takes U+001C-U+001F,
            # which the fast tokenizer drops as control characters)
            if c.isspace() and not 0x1C <= cp <= 0x1F:
                out.append(" ")
            elif cp == 0 or cp == 0xFFFD or unicodedata.category(c).startswith("C"):
                continue
            elif _is_cjk(cp):
                out.append(f" {c} ")
            else:
                out.append(c)
        text = unicodedata.normalize("NFD", "".join(out))
        # lower-cased a character at a time, as the fast tokenizer does
        # (str.lower would write a final sigma as ς)
        return "".join(c.lower() for c in text if unicodedata.category(c) != "Mn")

    def words(self, text: str) -> List[str]:
        words: List[str] = []
        for chunk in self.normalize(text).split():
            cur = ""
            for c in chunk:
                if _is_punctuation(c):
                    if cur:
                        words.append(cur)
                    words.append(c)
                    cur = ""
                else:
                    cur += c
            if cur:
                words.append(cur)
        return words

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self.words(text):
            if len(word) > self.max_chars_per_word:
                ids.append(self.unk)
                continue
            pieces, start = [], 0
            while start < len(word):
                end = len(word)
                while end > start:
                    piece = word[start:end] if start == 0 else "##" + word[start:end]
                    if piece in self.vocab:
                        pieces.append(self.vocab[piece])
                        break
                    end -= 1
                if end == start:  # no piece matches: the whole word is unknown
                    pieces = [self.unk]
                    break
                start = end
            ids.extend(pieces)
        return ids

    def batch(self, texts: Sequence[str], max_length: int = 32
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, attention_mask), each (B, max_length) int64: [CLS] + the
        first ``max_length - 2`` tokens + [SEP], padded with [PAD]."""
        ids = np.full((len(texts), max_length), self.pad, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            row = [self.cls] + self.encode(t)[:max_length - 2] + [self.sep]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask


def resolve_bert_snapshot() -> Optional[str]:
    """A local ``bert-base-uncased`` snapshot directory of the HF cache
    that holds ``pytorch_model.bin`` and ``vocab.txt``, or None."""
    hub = os.path.expanduser(os.environ.get("HF_HOME", "~/.cache/huggingface"))
    snaps = os.path.join(hub, "hub", "models--bert-base-uncased", "snapshots")
    if not os.path.isdir(snaps):
        return None
    for name in sorted(os.listdir(snaps)):
        d = os.path.join(snaps, name)
        if all(os.path.isfile(os.path.join(d, f))
               for f in ("pytorch_model.bin", "vocab.txt")):
            return d
    return None


def load_bert(seed: int = 0, require_parity: bool = False):
    """(BertModel, tokenizer): the pretrained tower and its WordPiece
    tokenizer from :func:`resolve_bert_snapshot`; with no snapshot a
    seeded random BERT-base and ``HashTokenizer(30522)`` (warned), or a
    ``RuntimeError`` under ``require_parity``."""
    from lsdm_tpu_torch.models.text import HashTokenizer
    from lsdm_tpu_torch.weights import bert_state_dict

    snap = resolve_bert_snapshot()
    if snap is not None:
        cfg_path = os.path.join(snap, "config.json")
        cfg = BertConfig.from_json(cfg_path) if os.path.isfile(cfg_path) else BertConfig()
        model = BertModel(cfg)
        sd = torch.load(os.path.join(snap, "pytorch_model.bin"), map_location="cpu",
                        weights_only=True)
        model.load_state_dict(bert_state_dict(sd))
        return model, WordPieceTokenizer(os.path.join(snap, "vocab.txt"))
    if require_parity:
        raise RuntimeError(
            "BERT text encoder requested for a parity-grade evaluation but "
            "no cached bert-base-uncased model was found (offline "
            "environment). Populate the HuggingFace cache "
            "(~/.cache/huggingface) with bert-base-uncased first.")
    warnings.warn(
        "no cached bert-base-uncased found: using a random-init BERT + hash "
        "tokenizer. Embeddings will NOT match the reference's pretrained "
        "tower.", stacklevel=3)
    cfg = BertConfig()
    return init_bert_weights(BertModel(cfg), seed), HashTokenizer(cfg.vocab_size)
