"""The port's text towers and tokenizers against the JAX package.

CLIP's BPE tokenizer (its word split written over ``unicodedata``: the
port does not depend on ``regex``) must give the JAX tokenizer's ids
exactly; the CLIP tower, with JAX's parameters carried across, must give
the JAX tower's embeddings; BERT is held to ``FlaxBertModel`` (the JAX
package's BERT) through the Flax-params bridge, and the WordPiece tokenizer
to ``BertTokenizerFast``.  JAX runs at ``highest`` matmul precision, as in
``tests/test_clip_parity.py``.

Tolerance of the towers: max |port - JAX| <= 1e-5 * max(1, max |JAX|), both
sides float32 (they differ in the order of the sums and in LayerNorm's
variance, which flax takes as E[x^2] - E[x]^2).
"""

import gzip
import json
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch

from lsdm_tpu.models import text as jax_text
from lsdm_tpu_torch.models import bert as bert_lib
from lsdm_tpu_torch.models import text as text_lib
from lsdm_tpu_torch.tools import vendor_clip_bpe as vendor_tool
from lsdm_tpu_torch.weights import (bert_state_dict_from_flax, clip_text_state_dict,
                                    clip_text_state_dict_from_jax)

TOWER_RTOL = 1e-5

PROMPTS = [
    "place the chair on the table", "THE TABLE", "chairs, tables!",
    "place   the    chair", "it's the person's chair, they'll sit; we'd've",
    "I'M HERE 'S 'T 'RE 'VE 'M 'LL 'D", "x²+y² = ½ of Ⅻ", "room 1024 has 3 chairs",
    "café naïve résumé", "放置一把椅子 next to 人", "a 🪑 and a 🛋️", "\tline\nbreak\r\x0b\x0c",
    "<|startoftext|>chair<|endoftext|>", "<|ſtartoftext|> 'ſ 'S", "ͅaͅ", "!!!'s'd", "",
    "ΟΔΟΣ Σ", "İstanbul ǅ ß ﬁ", "   ", "a-b_c.d/e\\f", "ÀÉÎÕÜ", "１２３ＡＢＣ",
]


@pytest.fixture(autouse=True)
def _high_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture
def merges(tmp_path):
    """A small CLIP-scheme merges file (as tests/test_clip_parity.py
    writes one)."""
    pairs = [("t", "h"), ("th", "e</w>"), ("c", "h"), ("ch", "a"), ("i", "r</w>"),
             ("cha", "ir</w>"), ("t", "a"), ("b", "l"), ("ta", "bl"), ("tabl", "e</w>"),
             ("o", "n</w>"), ("p", "l"), ("a", "c"), ("pl", "ac"), ("plac", "e</w>"),
             ("'", "s</w>"), ("c", "a"), ("Ã", "©</w>")]
    path = tmp_path / "bpe_merges.txt.gz"
    with gzip.open(path, "wb") as f:
        f.write(("#version: synthetic\n" + "\n".join(" ".join(m) for m in pairs)
                 + "\n").encode())
    return str(path)


def _no_sources(monkeypatch, tmp_path, asset="no_asset.gz"):
    monkeypatch.delenv("LSDM_TPU_CLIP_BPE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "empty_hf"))
    monkeypatch.setattr(text_lib, "CLIP_BPE_ASSET", str(tmp_path / asset))
    monkeypatch.setattr(jax_text, "CLIP_BPE_ASSET", str(tmp_path / asset))


def test_tokenizer_ids_equal_jax_on_the_fixed_prompts(merges):
    ours, ref = text_lib.SimpleTokenizer(merges), jax_text.SimpleTokenizer(merges)
    for p in PROMPTS:
        assert ours.encode(p) == ref.encode(p), p
    assert (ours.sot, ours.eot) == (ref.sot, ref.eot)
    assert ours.encoder == ref.encoder and ours.bpe_ranks == ref.bpe_ranks


def test_tokenizer_ids_equal_jax_for_every_code_point_below_u3000(merges):
    """Each code point alone and inside "a{c}1".  Left out: code points
    that this Python's Unicode database leaves unassigned and the ``regex``
    module's newer one assigns as letters or numbers (five below U+3000);
    the two tokenizers class them by their own Unicode versions."""
    ours, ref = text_lib.SimpleTokenizer(merges), jax_text.SimpleTokenizer(merges)
    newer = {cp for cp in range(0x3000) if not 0xD800 <= cp <= 0xDFFF
             and unicodedata.category(chr(cp)) == "Cn"
             and regex.fullmatch(r"[\p{L}\p{N}]", chr(cp))}
    assert len(newer) <= 5, sorted(map(hex, newer))
    for cp in range(0x3000):
        if cp in newer or 0xD800 <= cp <= 0xDFFF:
            continue
        for s in (chr(cp), f"a{chr(cp)}1"):
            assert ours.encode(s) == ref.encode(s), (hex(cp), s)


def test_hash_tokenizer_and_tokenize_batch_equal_jax(merges):
    texts = PROMPTS + [" ".join(["table"] * 40)]
    for ours, ref in ((text_lib.HashTokenizer(), jax_text.HashTokenizer()),
                      (text_lib.HashTokenizer(30522), jax_text.HashTokenizer(30522)),
                      (text_lib.SimpleTokenizer(merges), jax_text.SimpleTokenizer(merges))):
        for ctx, pad in ((22, 77), (20, 32)):
            got = text_lib.tokenize_batch(ours, texts, ctx, pad)
            want = jax_text.tokenize_batch(ref, texts, ctx, pad)
            assert got.dtype == np.int64 and got.shape == (len(texts), pad)
            np.testing.assert_array_equal(got, want)


def _jax_clip(width, heads, layers, embed, vocab=49408, ctx=77, seed=0):
    model = jax_text.CLIPTextTransformer(vocab_size=vocab, context_length=ctx,
                                         width=width, heads=heads, layers=layers,
                                         embed_dim=embed)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, ctx), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _tokens(vocab, ctx, B, seed=1):
    """[SOT] body [EOT] zero-pad rows, EOT = vocab - 1 (the argmax)."""
    rng = np.random.RandomState(seed)
    toks = np.zeros((B, ctx), np.int64)
    for i in range(B):
        n = rng.randint(2, min(ctx - 2, 30))
        toks[i, 0] = vocab - 2
        toks[i, 1:1 + n] = rng.randint(1, vocab - 2, n)
        toks[i, 1 + n] = vocab - 1
    return toks


def _assert_tower_close(got, want):
    bound = TOWER_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"max |port - JAX| {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("width,heads,layers,embed,B", [(64, 4, 3, 32, 3),
                                                        (512, 8, 12, 512, 2)],
                         ids=["small", "full_width"])
def test_clip_tower_equals_jax(width, heads, layers, embed, B):
    model, params = _jax_clip(width, heads, layers, embed)
    toks = _tokens(49408, 77, B)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(toks, jnp.int32)))
    ours = text_lib.CLIPTextTransformer(width=width, heads=heads, layers=layers,
                                        embed_dim=embed)
    ours.load_state_dict(clip_text_state_dict_from_jax(params))  # strict
    with torch.no_grad():
        got = ours(torch.from_numpy(toks)).numpy()
    assert got.shape == (B, embed)
    _assert_tower_close(got, want)


def _hf_clip(vocab=512, width=64, heads=4, layers=3, embed=32, ctx=77):
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection

    torch.manual_seed(0)
    cfg = CLIPTextConfig(vocab_size=vocab, hidden_size=width,
                         intermediate_size=width * 4, num_hidden_layers=layers,
                         num_attention_heads=heads, max_position_embeddings=ctx,
                         projection_dim=embed, hidden_act="quick_gelu",
                         eos_token_id=vocab - 1, bos_token_id=vocab - 2)
    return CLIPTextModelWithProjection(cfg).eval()


def _openai_naming(sd, layers):
    """The HF tower's weights under OpenAI's names, prefixed as inside an
    SDM checkpoint, with vision and logit-scale keys beside them."""
    oa = {"clip_model.token_embedding.weight":
          sd["text_model.embeddings.token_embedding.weight"],
          "clip_model.positional_embedding":
          sd["text_model.embeddings.position_embedding.weight"],
          "clip_model.text_projection": sd["text_projection.weight"].T,
          "clip_model.ln_final.weight": sd["text_model.final_layer_norm.weight"],
          "clip_model.ln_final.bias": sd["text_model.final_layer_norm.bias"],
          "clip_model.logit_scale": torch.zeros(()),
          "clip_model.visual.proj": torch.zeros(4, 4)}
    for i in range(layers):
        p, q = f"text_model.encoder.layers.{i}", f"clip_model.transformer.resblocks.{i}"
        for a, b in (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                     ("self_attn.out_proj", "attn.out_proj"), ("mlp.fc1", "mlp.c_fc"),
                     ("mlp.fc2", "mlp.c_proj")):
            for leaf in ("weight", "bias"):
                oa[f"{q}.{b}.{leaf}"] = sd[f"{p}.{a}.{leaf}"]
        for leaf in ("weight", "bias"):
            oa[f"{q}.attn.in_proj_{leaf}"] = torch.cat(
                [sd[f"{p}.self_attn.{x}_proj.{leaf}"] for x in "qkv"], 0)
    return oa


@pytest.mark.parametrize("naming", ["hf", "openai"])
def test_clip_weight_namings_load_and_give_jax_output(naming):
    from lsdm_tpu.train.checkpoint import convert_clip_text

    vocab, width, heads, layers, embed = 512, 64, 4, 3, 32
    hf_sd = _hf_clip(vocab, width, heads, layers, embed).state_dict()
    sd = hf_sd if naming == "hf" else _openai_naming(hf_sd, layers)
    toks = _tokens(vocab, 77, 3)
    params = convert_clip_text({k: v.numpy() for k, v in hf_sd.items()})
    jax_model = jax_text.CLIPTextTransformer(vocab_size=vocab, width=width, heads=heads,
                                             layers=layers, embed_dim=embed)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(toks, jnp.int32)))
    ours = text_lib.CLIPTextTransformer(vocab_size=vocab, width=width, heads=heads,
                                        layers=layers, embed_dim=embed)
    ours.load_state_dict(clip_text_state_dict(sd))  # strict
    with torch.no_grad():
        got = ours(torch.from_numpy(toks)).numpy()
    _assert_tower_close(got, want)
    with pytest.raises(KeyError, match="unmapped CLIP parameter"):
        clip_text_state_dict({**sd, "denoiser.weight": torch.zeros(2)})


def _bert_config(**kw):
    from transformers import BertConfig

    return BertConfig(vocab_size=96, hidden_size=48, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=96,
                      max_position_embeddings=40, **kw)


def _bert_batch(vocab, B=3, S=32, seed=2):
    rng = np.random.RandomState(seed)
    ids = np.zeros((B, S), np.int64)
    mask = np.zeros((B, S), np.int64)
    for i, n in enumerate(rng.randint(3, S, B)):
        ids[i, :n] = rng.randint(1, vocab, n)
        mask[i, :n] = 1
    return ids, mask


def test_bert_tower_equals_flax_bert():
    from transformers import FlaxBertModel

    cfg = _bert_config()
    flax_model = FlaxBertModel(cfg, seed=3)
    ids, mask = _bert_batch(cfg.vocab_size)
    want = np.asarray(flax_model(input_ids=ids, attention_mask=mask).pooler_output)
    ours = bert_lib.BertModel(bert_lib.BertConfig(**{
        k: getattr(cfg, k) for k in ("vocab_size", "hidden_size", "num_hidden_layers",
                                     "num_attention_heads", "intermediate_size",
                                     "max_position_embeddings")}))
    ours.load_state_dict(bert_state_dict_from_flax(
        jax.tree.map(np.asarray, flax_model.params)))  # strict
    with torch.no_grad():
        got = ours(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (3, 48)
    _assert_tower_close(got, want)


_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "place", "the", "chair", "on",
          "table", "##s", "a", "sofa", "next", "to", "person", "!", ",", ".", "'", "cafe",
          "naive", "ch", "##air", "##ai", "##r", "tab", "##le", "人", "椅", "子", "-", "$",
          "1", "##2", "##3", "resume", "σ", "##σ", "ο", "##δ", "##ο", "istanbul", "i",
          "##stanbul"]


def test_wordpiece_tokenizer_equals_bert_tokenizer_fast(tmp_path):
    from transformers import BertTokenizerFast

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(_VOCAB) + "\n")
    ours = bert_lib.WordPieceTokenizer(str(vocab))
    ref = BertTokenizerFast(vocab_file=str(vocab), do_lower_case=True)
    texts = PROMPTS + ["Chairs on the TABLE!", "chairchair tables", "a" * 101,
                       "$123 1 12 13", "ΟΔΟΣ", "x\x1cy\x00z�w​",
                       " ".join(["table"] * 40)]
    ids, mask = ours.batch(texts, max_length=32)
    enc = ref(texts, padding="max_length", truncation=True, max_length=32,
              return_tensors="np")
    np.testing.assert_array_equal(ids, enc["input_ids"])
    np.testing.assert_array_equal(mask, enc["attention_mask"])


def _bert_snapshot(tmp_path):
    """A fake HF cache with a small ``bert-base-uncased`` snapshot: torch
    weights under the pretraining checkpoint's names (``bert.`` prefix,
    LayerNorm gamma/beta, a ``cls.`` head, the ``position_ids`` buffer),
    the vocabulary and the config."""
    from transformers import BertModel

    cfg = _bert_config()
    torch.manual_seed(4)
    hf = BertModel(cfg).eval()
    snap = tmp_path / "hf" / "hub" / "models--bert-base-uncased" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    sd = {"bert." + k.replace("LayerNorm.weight", "LayerNorm.gamma")
          .replace("LayerNorm.bias", "LayerNorm.beta"): v
          for k, v in hf.state_dict().items()}
    sd["cls.predictions.bias"] = torch.zeros(cfg.vocab_size)
    sd["bert.embeddings.position_ids"] = torch.arange(cfg.max_position_embeddings)
    torch.save(sd, snap / "pytorch_model.bin")
    (snap / "vocab.txt").write_text("\n".join(_VOCAB + [f"w{i}" for i in range(51)]) + "\n")
    (snap / "config.json").write_text(json.dumps(cfg.to_dict()))
    return hf, snap


def test_bert_encoder_reads_a_local_snapshot_as_hf_does(tmp_path, monkeypatch):
    from transformers import BertTokenizerFast

    hf, snap = _bert_snapshot(tmp_path)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    enc = text_lib.TextEncoder("BERT", dim=48, device="cpu", require_parity=True)
    assert isinstance(enc.tokenizer, bert_lib.WordPieceTokenizer)
    texts = ["place the chair on the table", "a sofa next to the person!"]
    tok = BertTokenizerFast.from_pretrained(str(snap))
    b = tok(texts, padding="max_length", truncation=True, max_length=32,
            return_tensors="pt")
    with torch.no_grad():
        want = hf(input_ids=b["input_ids"], attention_mask=b["attention_mask"]
                  ).pooler_output.numpy()
    assert enc._bert_proj is None  # a 48-wide snapshot asked for dim 48: no projection
    _assert_tower_close(enc.encode(texts), want)


@pytest.fixture(scope="module")
def full_clip_params():
    return _jax_clip(512, 8, 12, 512, seed=5)[1]


def test_text_encoder_clip_equals_jax(merges, full_clip_params):
    texts = PROMPTS[:6] + PROMPTS[:2]
    ref = jax_text.TextEncoder("CLIP", dim=512, params=full_clip_params, bpe_path=merges)
    ours = text_lib.TextEncoder("CLIP", dim=512, bpe_path=merges, device="cpu",
                                state_dict=clip_text_state_dict_from_jax(full_clip_params))
    got = ours.encode(texts)
    assert got.dtype == np.float32 and got.shape == (8, 512)
    _assert_tower_close(got, ref.encode(texts))
    np.testing.assert_array_equal(got[6:], got[:2])  # the per-prompt cache
    assert next(ours.model.parameters()).device.type == "cpu"


def test_text_encoder_bert_fallback_equals_jax():
    """No snapshot: both fall back, warned, to a random BERT-base with the
    hash tokenizer and a seeded 768 -> dim projection; with the JAX tower's
    parameters carried across the port gives JAX's embeddings."""
    texts = ["sit on the chair", "a lamp", "PUT a Sofa  in front"]
    with pytest.warns(UserWarning, match="random-init"):
        ref = jax_text.TextEncoder("BERT", dim=32, seed=7)
    with pytest.warns(UserWarning, match="random-init"):
        ours = text_lib.TextEncoder("BERT", dim=32, seed=7, device="cpu")
    assert isinstance(ours.tokenizer, text_lib.HashTokenizer)
    assert ours.tokenizer.vocab_size == 30522
    np.testing.assert_array_equal(ours._bert_proj, ref._bert_proj)
    ours.model.load_state_dict(bert_state_dict_from_flax(
        jax.tree.map(np.asarray, ref._bert.params)))
    _assert_tower_close(ours.encode(texts), ref.encode(texts))
    # the seeded random tower has Flax BERT's distributions
    w = ours.model.encoder.layer[0].attention.self.query.weight
    assert abs(float(w.detach().std()) - 0.02) < 1e-3


def test_text_encoder_hash_and_cached_equal_jax():
    texts = PROMPTS + PROMPTS[:3]
    np.testing.assert_array_equal(text_lib.TextEncoder("HASH", dim=64).encode(texts),
                                  jax_text.TextEncoder("HASH", dim=64).encode(texts))
    cache = {"a": np.arange(8, dtype=np.float32), "b": np.ones(8, np.float32)}
    got = text_lib.TextEncoder("CACHED", dim=8, cache=dict(cache)).encode(["b", "a", "b"])
    want = jax_text.TextEncoder("CACHED", dim=8, cache=dict(cache)).encode(["b", "a", "b"])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError):
        text_lib.TextEncoder("CACHED", dim=8, cache=cache).encode(["missing"])


def test_text_encoder_parity_guards_and_warnings_follow_jax(tmp_path, monkeypatch):
    _no_sources(monkeypatch, tmp_path)
    for lib in (jax_text, text_lib):
        with pytest.raises(RuntimeError, match="BPE merges") as err:
            lib.TextEncoder("CLIP", dim=16, require_parity=True)
        assert text_lib.CLIP_BPE_HELP.split(" via ")[0] in str(err.value)
        with pytest.raises(RuntimeError, match="bert-base-uncased"):
            lib.TextEncoder("BERT", dim=16, require_parity=True)
    with pytest.warns(UserWarning, match="hash tokenizer"):
        enc = text_lib.TextEncoder("CLIP", dim=16, device="cpu")
    assert isinstance(enc.tokenizer, text_lib.HashTokenizer)
    assert enc.encode(["a chair"]).shape == (1, 16)
    with pytest.raises(NotImplementedError):
        text_lib.TextEncoder("T5")


def test_text_encoder_random_clip_tower_has_jax_distributions(merges):
    enc = text_lib.TextEncoder("CLIP", dim=512, bpe_path=merges, seed=1, device="cpu")
    sd = enc.model.state_dict()
    assert abs(float(sd["token_embedding.weight"].std()) - 0.02) < 1e-4
    assert abs(float(sd["positional_embedding"].std()) - 0.01) < 5e-4
    assert abs(float(sd["text_projection"].std()) - 512 ** -0.5) < 1e-3
    w = sd["transformer.resblocks.0.mlp.c_fc.weight"]  # lecun_normal over (out, in)
    assert abs(float(w.std()) - 2048 ** -0.5) < 1e-3
    assert float(w.abs().max()) <= 2 * 2048 ** -0.5 / 0.8796 + 1e-6  # truncated at 2 sigma
    a = sd["transformer.resblocks.0.attn.in_proj_weight"]
    assert float(a.abs().max()) <= (6 / 2048) ** 0.5
    again = text_lib.TextEncoder("CLIP", dim=512, bpe_path=merges, seed=1, device="cpu")
    np.testing.assert_array_equal(enc.encode(["a chair"]), again.encode(["a chair"]))


def test_resolve_clip_bpe_and_auto_follow_jax(tmp_path, monkeypatch, merges):
    _no_sources(monkeypatch, tmp_path)
    assert text_lib.resolve_clip_bpe(None) is None
    assert text_lib.resolve_text_encoder("auto") == "HASH"
    assert text_lib.resolve_text_encoder("CLIP") == "CLIP"
    assert text_lib.resolve_text_encoder("auto", merges) == "CLIP"
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "merges.txt").write_text("#v\nt h\n")
    assert text_lib.resolve_clip_bpe(str(tmp_path / "d")) == str(tmp_path / "d" / "merges.txt")
    monkeypatch.setenv("LSDM_TPU_CLIP_BPE", merges)
    assert text_lib.resolve_clip_bpe(None) == jax_text.resolve_clip_bpe(None) == merges
    monkeypatch.delenv("LSDM_TPU_CLIP_BPE")
    snap = tmp_path / "hf" / "hub" / "models--openai--clip-vit-base-patch32" / "snapshots" / "x"
    snap.mkdir(parents=True)
    (snap / "merges.txt").write_text("#v\nt h\n")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert text_lib.resolve_clip_bpe(None) == jax_text.resolve_clip_bpe(None) == str(
        snap / "merges.txt")


_TOY_MERGES = "#version: test\nt h\nth e</w>\nc h\nch a\ncha i\nchai r</w>\n"


def test_vendor_writes_the_asset_and_sidecar_jax_writes(tmp_path, monkeypatch):
    _no_sources(monkeypatch, tmp_path)
    src = tmp_path / "merges.txt"
    src.write_text(_TOY_MERGES)
    name = "bpe_simple_vocab_16e6.txt.gz"
    with pytest.raises(ValueError, match="canonical"):
        text_lib.vendor_clip_bpe(str(src), dest=str(tmp_path / "port" / name))
    ours = text_lib.vendor_clip_bpe(str(src), dest=str(tmp_path / "port" / name), force=True)
    ref = jax_text.vendor_clip_bpe(str(src), dest=str(tmp_path / "jax" / name), force=True)
    assert {k: v for k, v in ours.items() if k != "dest"} == {
        k: v for k, v in ref.items() if k != "dest"}
    for suffix in ("", ".sha256"):
        a = tmp_path / "port" / (name + suffix)
        b = tmp_path / "jax" / (name + suffix)
        if suffix:
            assert a.read_text() == b.read_text()
        else:
            assert gzip.open(a).read() == gzip.open(b).read() == _TOY_MERGES.encode()
    with pytest.raises(FileNotFoundError, match="not a merges file"):
        text_lib.vendor_clip_bpe(str(tmp_path / "typo" / "merges.txt"))


def test_vendor_tool_pins_the_asset_and_the_pin_rejects_a_corrupted_one(
        tmp_path, monkeypatch, capsys):
    _no_sources(monkeypatch, tmp_path, asset="assets/bpe_simple_vocab_16e6.txt.gz")
    src = tmp_path / "merges.txt"
    src.write_text(_TOY_MERGES)
    assert vendor_tool.main(["--source", str(src)]) == 2  # not canonical
    assert vendor_tool.main(["--source", str(src), "--force"]) == 0
    assert json.loads(capsys.readouterr().out)["parity_grade"] is False
    asset = text_lib.CLIP_BPE_ASSET
    assert text_lib.resolve_clip_bpe(None) == asset  # hash ok, found with no flag
    assert text_lib.SimpleTokenizer(asset).encode("the chair") == \
        text_lib.SimpleTokenizer(str(src)).encode("the chair")
    with gzip.open(asset, "wb") as f:  # swap the content, keep the sidecar
        f.write(b"#version: tampered\nx y\n")
    with pytest.raises(RuntimeError, match="pinned"):
        text_lib.resolve_clip_bpe(None)
    with pytest.raises(RuntimeError, match="pinned"):  # JAX's pin agrees
        jax_text.resolve_clip_bpe(None)
