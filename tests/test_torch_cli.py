"""The port's evaluation entry point and its parts against the JAX package.

The HASH text encoder, the synthetic dataset writer, the loader, the
metrics and the ``.pt`` checkpoint loader each against their JAX
counterparts; then ``lsdm_tpu_torch.run.test_sdm`` end to end on the CPU,
holding the output contract of ``tests/test_e2e_cli.py``.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.data import dataset as jax_dataset
from lsdm_tpu.data.synthetic import generate as jax_generate
from lsdm_tpu.models.text import TextEncoder as JaxTextEncoder
from lsdm_tpu.ops import metrics as jax_metrics
from lsdm_tpu.ops.pointcloud import chamfer_distance as jax_chamfer
from lsdm_tpu.train.checkpoint import convert_torch_state_dict
from lsdm_tpu.train.checkpoint import load_torch_checkpoint as jax_load_torch_checkpoint
from lsdm_tpu_torch.checkpoint import load_torch_checkpoint
from lsdm_tpu_torch.config import SDMConfig
from lsdm_tpu_torch.data import dataset
from lsdm_tpu_torch.data.synthetic import generate
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.models.text import TextEncoder, resolve_text_encoder
from lsdm_tpu_torch.ops import metrics
from lsdm_tpu_torch.ops.pointcloud import chamfer_distance
from lsdm_tpu_torch.run import test_sdm
from lsdm_tpu_torch.weights import init_weights

PROMPTS = ["place a chair next to the person", "PUT a Sofa  in front",
           "", "tv_monitor"]


def test_hash_text_encoder_equals_jax_bit_for_bit():
    got = TextEncoder("HASH", dim=512).encode(PROMPTS + PROMPTS[:1])
    want = JaxTextEncoder("HASH", dim=512).encode(PROMPTS + PROMPTS[:1])
    assert got.dtype == np.float32 and got.shape == (5, 512)
    np.testing.assert_array_equal(got, want)


def test_text_encoder_auto_is_hash_offline_and_the_towers_run(monkeypatch, tmp_path):
    monkeypatch.delenv("LSDM_TPU_CLIP_BPE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))  # an empty HuggingFace cache
    assert resolve_text_encoder("auto") == "HASH"
    merges = tmp_path / "merges.txt"
    merges.write_text("#version: 0.2\n")
    assert resolve_text_encoder("auto", str(merges)) == "CLIP"
    assert resolve_text_encoder("HASH", str(merges)) == "HASH"
    clip = TextEncoder("CLIP", bpe_path=str(merges), device="cpu")
    with pytest.warns(UserWarning, match="random-init"):  # no BERT snapshot here
        bert = TextEncoder("BERT", device="cpu")
    for enc in (clip, bert):
        emb = enc.encode(PROMPTS[:2])
        assert emb.shape == (2, 512) and np.isfinite(emb).all()


@pytest.mark.parametrize("datatype", ["proxd", "humanise"])
def test_synthetic_dataset_and_loader_match_jax(tmp_path, datatype):
    a, b = tmp_path / "port", tmp_path / "jax"
    kw = dict(n_scenes=2, n_seqs=5, pnt_size=16, seed=3, split="test")
    data_a = generate(str(a), datatype, **kw)
    jax_generate(str(b), datatype, **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors

    cls = "ProxDatasetTxt" if datatype == "proxd" else "Humanise"
    kw = dict(objs_data_dir=str(a / "objs"), pnt_size=16)
    ds = getattr(dataset, cls)(data_a, **kw)
    ref = getattr(jax_dataset, cls)(data_a, **kw)
    assert len(ds) == len(ref) == 5
    for i in range(len(ds)):
        for got, want in zip(ds[i], ref[i]):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # batches of 2: the last one pads by repeating its last item
    batches = list(dataset.DataLoader(ds, 2))
    refs = list(jax_dataset.DataLoader(ref, 2))
    assert len(batches) == len(refs) == 3
    for got, want in zip(batches, refs):
        for field in ("mask", "given_objs", "given_cats", "target_verts",
                      "target_cat", "text", "seq_names"):
            np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                          np.asarray(getattr(want, field)))
    assert batches[-1].seq_names[0] == batches[-1].seq_names[1]


def test_metrics_match_jax():
    rs = np.random.RandomState(4)
    pred = rs.randn(2, 48, 3).astype(np.float32)
    gt = (rs.randn(2, 48, 3) * 0.8).astype(np.float32)
    p, g = torch.from_numpy(pred), torch.from_numpy(gt)
    # float32 distances rounded in another order (the port's separate
    # products against XLA's dot): ~1e-7 relative
    np.testing.assert_allclose(float(chamfer_distance(p, g)),
                               float(jax_chamfer(jnp.asarray(pred), jnp.asarray(gt))),
                               rtol=1e-6, err_msg="chamfer")
    np.testing.assert_allclose(metrics.emd(p, g),
                               jax_metrics.emd(jnp.asarray(pred), jnp.asarray(gt)),
                               rtol=1e-6, err_msg="emd")
    for th in (0.1, 0.5):  # no distance lies within 1e-3 of either threshold
        got = metrics.fscore(p[0], g[0], th)
        want = jax_metrics.fscore(jnp.asarray(pred[0]), jnp.asarray(gt[0]), th)
        np.testing.assert_allclose([float(x) for x in got],
                                   [float(x) for x in want], rtol=1e-6,
                                   err_msg=f"fscore at {th}")
    scores = rs.rand(6, 13).astype(np.float32)
    labels = rs.randint(0, 13, 6)
    got = metrics.topk_accuracy(torch.from_numpy(scores), torch.from_numpy(labels),
                                (1, 3, 5))
    want = jax_metrics.topk_accuracy(jnp.asarray(scores), jnp.asarray(labels),
                                     (1, 3, 5))
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want],
                               err_msg="top-k accuracy")


@pytest.mark.parametrize("case", ["pairs", "all_equal", "one_hot"])
def test_topk_accuracy_breaks_ties_as_jax(case):
    # equal scores rank by the lowest class index in jax.lax.top_k
    rs = np.random.RandomState(7)
    C = 13
    if case == "pairs":  # every row: two classes share the best score
        scores = rs.rand(12, C).astype(np.float32) * 0.5
        hi = np.stack([rs.choice(C, 2, replace=False) for _ in range(12)])
        scores[np.arange(12)[:, None], hi] = 0.9
    elif case == "all_equal":
        scores = np.full((12, C), 0.25, np.float32)
    else:  # one class ahead, the rest tied: top-3 takes the lowest two
        scores = np.zeros((12, C), np.float32)
        scores[np.arange(12), rs.randint(0, C, 12)] = 1.0
    labels = np.arange(12) % C
    got = metrics.topk_accuracy(torch.from_numpy(scores), torch.from_numpy(labels),
                                (1, 3))
    want = jax_metrics.topk_accuracy(jnp.asarray(scores), jnp.asarray(labels), (1, 3))
    np.testing.assert_array_equal([float(x) for x in got], [float(x) for x in want])


TINY = SDMConfig(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4, vert_dims=24,
                 pcd_points=32)


def test_torch_checkpoint_round_trip_with_the_jax_loader(tmp_path):
    model = init_weights(SceneDiffusionModel(TINY), 5)
    sd = model.state_dict()
    path = str(tmp_path / "model.pt")
    torch.save({"model_state_dict": {**sd, "clip_model.proj": torch.ones(2)},
                "epoch": 7}, path)
    port = SceneDiffusionModel(TINY)
    extra = load_torch_checkpoint(path, port)
    assert extra == {"epoch": 7}
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k]), k
    params, stats, _ = jax_load_torch_checkpoint(path, max_cats=TINY.max_cats)
    want_p, want_s = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, TINY.max_cats)
    for got, want in ((params, want_p), (stats, want_s)):
        got_l = jax.tree_util.tree_leaves_with_path(got)
        want_l = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(got_l) == len(want_l)
        for path_, leaf in got_l:
            np.testing.assert_array_equal(np.asarray(leaf),
                                          np.asarray(want_l[path_]))
    # a category head of another width fails the strict load
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_torch_checkpoint(path, SceneDiffusionModel(
            dataclasses.replace(TINY, max_cats=11)))


@pytest.mark.parametrize("ball_impl", ["auto", "fused"])
def test_test_sdm_cli_end_to_end_on_cpu(tmp_path, ball_impl):
    root = str(tmp_path)
    generate(root, "proxd", n_scenes=1, n_seqs=3, pnt_size=32, seed=3,
             split="test")
    model = init_weights(SceneDiffusionModel(SDMConfig(pcd_points=32,
                                                       vert_dims=32)), 2)
    ckpt = os.path.join(root, "model.pt")
    torch.save({"model_state_dict": model.state_dict()}, ckpt)
    out = os.path.join(root, "out")
    final = test_sdm.main([
        os.path.join(root, "proxd_test"), "--objs_data_dir",
        os.path.join(root, "objs"), "--load_model", ckpt, "--output_dir", out,
        "--diffusion_steps", "4", "--batch_size", "2", "--pcd_points", "32",
        "--device", "cpu", "--ball_impl", ball_impl])
    # output contract (reference run/test_sdm.py:210-232)
    lines = open(os.path.join(out, "results.txt")).read().splitlines()
    assert [line.split(":")[0] for line in lines[-5:]] == [
        "Final Chamfer distance", "Final EMD", "Final F1 score",
        "Category accuracy", "Top 3 accuracy"]
    assert len(lines) == 3 + 5  # one line per sequence; the padded tail is not scored
    assert all(np.isfinite(v) for v in final.values())
    preds = sorted(os.listdir(os.path.join(out, "predictions")))
    assert len(preds) == 3
    for sub in ("predictions", "guiding_points"):
        for name in preds:
            arr = np.load(os.path.join(out, sub, name))
            assert arr.shape == (32, 3) and arr.dtype == np.float32
            assert np.isfinite(arr).all()


@pytest.mark.parametrize("flag", [
    ["--gather_bwd", "matmul"], ["--gather_bwd", "matmul_fwd"], ["--platform", "cpu"]])
def test_test_sdm_cli_refuses_jax_flags_with_a_reason(tmp_path, flag):
    with pytest.raises(SystemExit, match=f"{flag[0]} .*not ported"):
        test_sdm.main([str(tmp_path), "--device", "cpu", *flag])


def test_test_sdm_cli_takes_gather_bwd_scatter(tmp_path):
    # the port's exact gather: past the flag checks, the run stops at the
    # missing split
    with pytest.raises(FileNotFoundError):
        test_sdm.main([str(tmp_path / "none"), "--device", "cpu", "--gather_bwd",
                       "scatter", "--output_dir", str(tmp_path / "out")])


def test_test_sdm_cli_refuses_what_the_port_cannot_run(tmp_path):
    with pytest.raises(SystemExit, match="torch .pt"):
        test_sdm.main([str(tmp_path), "--load_model", "model.ckpt"])
    if not torch.cuda.is_available():  # no silent CPU run
        with pytest.raises(SystemExit, match="--device cpu"):
            test_sdm.main([str(tmp_path)])


class _TowerReached(Exception):
    pass


@pytest.mark.parametrize("cli,flag", [("test_sdm", "--bpe_path"), ("test_sdm", "--clip_weights"),
                                      ("scene_edit", "--bpe_path"), ("train_sdm", "--bpe_path")])
def test_cli_text_flags_reach_the_tower(tmp_path, monkeypatch, cli, flag):
    """The flags the CLIs once refused are taken and handed to the text
    encoder: ``--bpe_path`` makes ``auto`` CLIP with that merges file,
    ``--clip_weights`` hands over the tower's state dict (an HF-named one,
    converted to the port's names)."""
    from lsdm_tpu_torch.models import text as text_lib
    from lsdm_tpu_torch.run import scene_edit, train_sdm

    monkeypatch.delenv("LSDM_TPU_CLIP_BPE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "empty_hf"))
    monkeypatch.setattr(text_lib, "CLIP_BPE_ASSET", str(tmp_path / "no_asset.gz"))
    got = {}

    def stub(encoder_type, **kw):
        got.update(kw, encoder_type=encoder_type)
        raise _TowerReached

    monkeypatch.setattr(text_lib, "TextEncoder", stub)
    root = str(tmp_path)
    split = "train" if cli == "train_sdm" else "test"
    data = generate(root, "proxd", n_scenes=1, n_seqs=2, pnt_size=16, seed=1, split=split)
    merges = tmp_path / "merges.txt"
    merges.write_text("#version: 0.2\nt h\n")
    common = ["--objs_data_dir", os.path.join(root, "objs"), "--device", "cpu",
              "--pcd_points", "16"]
    if flag == "--bpe_path":
        args = common + ["--bpe_path", str(merges)]
    else:
        hf = {"text_model.embeddings.token_embedding.weight": torch.randn(6, 4),
              "text_projection.weight": torch.randn(2, 4)}
        torch.save({"state_dict": hf}, tmp_path / "clip.pt")
        args = common + ["--text_encoder", "CLIP", "--clip_weights", str(tmp_path / "clip.pt")]
    main = {"test_sdm": test_sdm.main, "scene_edit": scene_edit.main,
            "train_sdm": train_sdm.main}[cli]
    argv = (["--train_data_dir", data, "--save_dir", os.path.join(root, "out")]
            if cli == "train_sdm" else [data, "--output_dir", os.path.join(root, "out")])
    with pytest.raises(_TowerReached):
        main(argv + args)
    assert got["encoder_type"] == "CLIP" and got["device"] == torch.device("cpu")
    if flag == "--bpe_path":
        assert got["bpe_path"] == str(merges)
    else:
        sd = got["state_dict"]
        assert sorted(sd) == ["text_projection", "token_embedding.weight"]
        assert torch.equal(sd["text_projection"], hf["text_projection.weight"].T)


def test_test_sdm_cli_runs_the_clip_tower(tmp_path, monkeypatch):
    """``--text_encoder auto`` with a merges file runs the CLIP tower with
    the weights of ``--clip_weights``; with ``--load_model`` and no merges
    source, CLIP refuses with the JAX CLI's help text."""
    from lsdm_tpu_torch.models import text as text_lib
    from lsdm_tpu_torch.weights import clip_text_state_dict

    monkeypatch.delenv("LSDM_TPU_CLIP_BPE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "empty_hf"))
    monkeypatch.setattr(text_lib, "CLIP_BPE_ASSET", str(tmp_path / "no_asset.gz"))
    root = str(tmp_path)
    data = generate(root, "proxd", n_scenes=1, n_seqs=2, pnt_size=32, seed=3, split="test")
    merges = tmp_path / "merges.txt"
    merges.write_text("#version: 0.2\np l\npl a\nc h\nch a\n")
    tower = text_lib.init_clip_weights(text_lib.CLIPTextTransformer(), 4)
    torch.save(tower.state_dict(), tmp_path / "clip.pt")
    seen = []
    real = text_lib.TextEncoder

    class Recording(real):
        def encode(self, texts):
            seen.append(self)
            return super().encode(texts)

    monkeypatch.setattr(text_lib, "TextEncoder", Recording)
    common = ["--objs_data_dir", os.path.join(root, "objs"), "--diffusion_steps", "2",
              "--batch_size", "2", "--pcd_points", "32", "--device", "cpu"]
    final = test_sdm.main([data, "--output_dir", os.path.join(root, "out"),
                           "--bpe_path", str(merges),
                           "--clip_weights", str(tmp_path / "clip.pt")] + common)
    assert np.isfinite(final["cfd"])
    enc = seen[0]
    assert enc.encoder_type == "CLIP" and isinstance(enc.tokenizer, text_lib.SimpleTokenizer)
    for k, v in clip_text_state_dict(tower.state_dict()).items():
        assert torch.equal(enc.model.state_dict()[k], v), k
    assert all(np.isfinite(e).all() and e.shape == (512,) for e in enc.cache.values())

    model = init_weights(SceneDiffusionModel(SDMConfig(pcd_points=32, vert_dims=32)), 2)
    torch.save({"model_state_dict": model.state_dict()}, tmp_path / "model.pt")
    with pytest.raises(RuntimeError, match="Provide the CLIP BPE merges via --bpe_path"):
        test_sdm.main([data, "--output_dir", os.path.join(root, "out2"), "--text_encoder",
                       "CLIP", "--load_model", str(tmp_path / "model.pt")] + common)


def test_predict_contact_cli_samples_as_test_sdm(tmp_path):
    """``predict_contact`` at full width (1024 points, T = 2) on the CPU:
    one finite (1024, 3) float32 file a sequence under ``predictions/``,
    equal to what ``test_sdm`` writes from the same checkpoint and seed
    (the same sampling loop without the metrics)."""
    from lsdm_tpu_torch.run import predict_contact

    root = str(tmp_path)
    data = generate(root, "proxd", n_scenes=1, n_seqs=3, pnt_size=1024, seed=5,
                    split="test")
    model = init_weights(SceneDiffusionModel(SDMConfig()), 3)
    torch.save({"model_state_dict": model.state_dict()}, tmp_path / "model.pt")
    common = [data, "--objs_data_dir", os.path.join(root, "objs"), "--load_model",
              str(tmp_path / "model.pt"), "--diffusion_steps", "2", "--batch_size",
              "2", "--seed", "4", "--device", "cpu"]
    written = predict_contact.main(common + ["--output_dir", os.path.join(root, "p")])
    assert len(written) == 3
    test_sdm.main(common + ["--output_dir", os.path.join(root, "t")])
    for path in written:
        arr = np.load(path)
        assert arr.shape == (1024, 3) and arr.dtype == np.float32
        assert np.isfinite(arr).all()
        np.testing.assert_array_equal(
            arr, np.load(os.path.join(root, "t", "predictions", os.path.basename(path))))


def test_train_contactformer_cli_on_cpu(tmp_path):
    """``train_contactformer`` at its default width (mode 1: 6 + 6 layers,
    d_hid 512) on a synthetic 16-vertex contact split (synthetic mesh
    assets): 2 epochs of 2 steps write ``best_model_recon_acc.pt`` with its
    metadata, which loads into a ContactFormer, and finite logs."""
    import json

    import chip_smoke
    from lsdm_tpu_torch.data.mesh_assets import load_mesh_assets
    from lsdm_tpu_torch.models.contactformer import ContactFormer
    from lsdm_tpu_torch.run import train_contactformer

    data = chip_smoke.contact_split(str(tmp_path / "data"), n_seqs=2, frames=40,
                                    nv=16, seed=1)
    out = tmp_path / "out"
    res = train_contactformer.main([
        "--train_data_dir", data, "--mesh_ds_dir", str(tmp_path / "none"),
        "--save_dir", str(out), "--epochs", "2", "--steps_per_epoch", "2",
        "--max_frame", "8", "--jump_step", "2", "--device", "cpu"])
    assert np.isfinite(res["loss"]) and 0.0 <= res["acc"] <= 1.0
    ckpt = torch.load(out / "best_model_recon_acc.pt", weights_only=False)
    extra = json.loads((out / "best_model_recon_acc.pt.json").read_text())
    assert set(extra) == {"epoch", "loss", "acc"} and extra["loss"] == res["best_loss"]
    assets = load_mesh_assets(str(tmp_path / "none"), nv_override=(16, 4, 1))
    model = ContactFormer(assets.spiral_indices, assets.down_mats, seg_len=8)
    model.load_state_dict(ckpt["model_state_dict"])
    events = [json.loads(line) for line in (out / "logs" / "events.jsonl").open()]
    losses = [e["train/loss"] for e in events if "train/loss" in e]
    assert len(losses) == 2 and np.isfinite(losses).all()


@pytest.mark.parametrize("cli", ["predict_contact", "train_contactformer"])
def test_contact_clis_refuse_platform_and_a_missing_gpu(tmp_path, monkeypatch, cli):
    import importlib

    mod = importlib.import_module(f"lsdm_tpu_torch.run.{cli}")
    argv = ([str(tmp_path)] if cli == "predict_contact"
            else ["--train_data_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="--platform .*not ported"):
        mod.main(argv + ["--platform", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        mod.main(argv)


# ---------------------------------------------------------------- ATISS / MIME


def _reference_atiss_pt(path, contact: bool) -> str:
    """A reference-format ATISS (or MIME) ``.pt`` at the CLIs' widths
    (20 = 13 proxd categories + 7 classes, 4 layers, 8 heads, ff 1024,
    ResNet18 features of 64, scalar heads over 10 mixtures), from the torch
    replica of ``tests/test_atiss_conversion.py``."""
    from test_atiss_conversion import TATISS

    torch.manual_seed(3)
    tm = TATISS(20, n_layers=4, n_heads=8, dim_ff=1024, fs=64, contact=contact,
                n_mix=10)
    torch.save({"model_state_dict": tm.state_dict(), "epoch": 0}, path)
    return str(path)


def _numbers(path):
    return [float(line.rsplit(":", 1)[1]) for line in open(path)]


@pytest.mark.parametrize("kind", ["atiss", "mime"])
def test_baseline_eval_cli_equals_jax_on_a_reference_pt(tmp_path, monkeypatch, kind):
    """One reference-format ``.pt`` through the JAX package's and the port's
    ``test_{kind}`` on the same synthetic split (3 sequences, batch 2):
    both pick ResNet18 and the batch-axis quirk for a reference checkpoint;
    every number of ``results.txt`` within 2e-4 (printed at 4 decimals)
    and every ``predictions/*.npy`` within 1e-4."""
    import importlib
    import sys

    root = str(tmp_path)
    data = generate(root, "proxd", n_scenes=1, n_seqs=3, pnt_size=1024, seed=2,
                    split="test")
    pt = _reference_atiss_pt(tmp_path / "ref.pt", kind == "mime")
    common = [data, "--objs_data_dir", os.path.join(root, "objs"), "--load_model", pt,
              "--batch_size", "2"]
    jax_cli = importlib.import_module(f"lsdm_tpu.run.test_{kind}")
    monkeypatch.setattr(sys, "argv", [f"test_{kind}"] + common
                        + ["--output_dir", os.path.join(root, "jax")])
    jax_cli.main()
    port_cli = importlib.import_module(f"lsdm_tpu_torch.run.test_{kind}")
    final = port_cli.main(common + ["--output_dir", os.path.join(root, "port"),
                                    "--device", "cpu"])
    assert set(final) == {"cfd", "emd", "f1", "acc", "top3"}
    got = _numbers(os.path.join(root, "port", "results.txt"))
    want = _numbers(os.path.join(root, "jax", "results.txt"))
    assert len(got) == len(want) == 3 + 5
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    names = sorted(os.listdir(os.path.join(root, "jax", "predictions")))
    assert names == sorted(os.listdir(os.path.join(root, "port", "predictions")))
    for name in names:
        np.testing.assert_allclose(np.load(os.path.join(root, "port", "predictions", name)),
                                   np.load(os.path.join(root, "jax", "predictions", name)),
                                   rtol=0, atol=1e-4)


def test_train_atiss_and_generate_scenes_clis_on_cpu(tmp_path):
    """``train_atiss`` (1 epoch, batch 2) writes a ``.pt`` with its graph
    flags that ``test_atiss`` reads back; ``generate_scenes`` reads a
    reference ``.pt`` (ResNet18 and the quirk chosen for it) and the
    trained one, from scratch and from ``--complete_from``."""
    from lsdm_tpu_torch.run import generate_scenes, test_atiss, train_atiss

    root = str(tmp_path)
    train = generate(root, "proxd", n_scenes=1, n_seqs=4, pnt_size=1024, seed=1,
                     split="train")
    test = generate(root, "proxd", n_scenes=1, n_seqs=2, pnt_size=1024, seed=2,
                    split="test")
    objs = os.path.join(root, "objs")
    train_atiss.main(["--train_data_dir", train, "--objs_data_dir", objs, "--save_dir",
                      os.path.join(root, "out"), "--epochs", "1", "--batch_size", "2",
                      "--device", "cpu"])
    ckpt = torch.load(os.path.join(root, "out", "final_atiss.pt"), weights_only=False)
    assert ckpt["atiss_flags"] == {"feature_extractor": "simple", "freeze_bn": True,
                                   "torch_seq_axis_quirk": False, "pe": False}
    final = test_atiss.main([test, "--objs_data_dir", objs, "--load_model",
                             os.path.join(root, "out", "final_atiss.pt"), "--output_dir",
                             os.path.join(root, "eval"), "--device", "cpu"])
    assert np.isfinite(list(final.values())).all()
    for pt in (_reference_atiss_pt(tmp_path / "ref.pt", False),
               os.path.join(root, "out", "best_model_atiss.pt")):
        out = os.path.join(root, "gen", os.path.basename(pt))
        written = generate_scenes.main(["--load_model", pt, "--n_scenes", "2",
                                        "--max_boxes", "5", "--output_dir", out,
                                        "--device", "cpu"])
        assert len(written) == 2
        d = np.load(written[0])
        assert d["class_labels"].shape == (5, 20) and 1 <= int(d["count"]) <= 5
        assert int(d["valid_mask"].sum()) == int(d["count"])
    np.savez(tmp_path / "partial.npz", **{k: d[k][:1] for k in (
        "class_labels", "translations", "sizes", "angles")})
    written = generate_scenes.main([
        "--load_model", pt, "--n_scenes", "1", "--max_boxes", "3", "--complete_from",
        str(tmp_path / "partial.npz"), "--output_dir", os.path.join(root, "gen2"),
        "--device", "cpu"])
    d2 = np.load(written[0])
    assert d2["class_labels"].shape == (4, 20)
    np.testing.assert_array_equal(d2["translations"][0], d["translations"][0])


@pytest.mark.parametrize("cli", ["train_atiss", "train_mime", "train_cf_atiss",
                                 "test_atiss", "test_mime", "test_cf_atiss",
                                 "generate_scenes", "get_next_obj_class",
                                 "scene_completion"])
def test_atiss_clis_refuse_platform_flax_checkpoints_and_a_missing_gpu(
        tmp_path, monkeypatch, cli):
    """``--platform`` is refused with its reason, a flax ``.ckpt`` too (for
    ``--load_model``, ``--cf_ckpt``, ``--path_to_model``), and no CLI runs
    on the CPU unless ``--device cpu`` is asked for."""
    import importlib

    mod = importlib.import_module(f"lsdm_tpu_torch.run.{cli}")
    argv = (["--train_data_dir", str(tmp_path)] if cli.startswith("train")
            else [str(tmp_path)] if cli.startswith("test")
            else ["--load_model", str(tmp_path / "m.pt")] if cli == "generate_scenes"
            else ["--fitting_results_path", str(tmp_path), "--obj_dataset_path",
                  str(tmp_path)] if cli == "scene_completion" else [])
    with pytest.raises(SystemExit, match="--platform .*not ported"):
        mod.main(argv + ["--platform", "cpu"])
    flag = {"generate_scenes": None, "scene_completion": "--path_to_model"}.get(
        cli, None if cli.startswith("train") else "--load_model")
    for f in ([flag] if flag else []) + (["--cf_ckpt"] if cli.startswith("test") else []):
        with pytest.raises(SystemExit, match="flax .ckpt"):
            mod.main(argv + [f, str(tmp_path / "m.ckpt")])
    if cli == "generate_scenes":
        with pytest.raises(SystemExit, match="flax .ckpt"):
            mod.main(["--load_model", str(tmp_path / "m.ckpt")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        mod.main(argv)


def test_scene_completion_cli_equals_jax(tmp_path, monkeypatch, capsys):
    """JAX's and the port's ``scene_completion`` on two copies of one
    fitting directory (a fitted table, 16 human meshes of which every 8th
    counts, 12 of the 23 classes with 4 candidate meshes each), with the
    same ``--seed`` and two iterations: JAX's CLI seeds its model from
    ``--seed``, the port reads those weights from a ``.pt``
    (``atiss_state_dict_from_jax``).  The same classes are drawn, the same
    meshes written under the same paths, and their vertices agree within
    1e-6 (float32 ``.obj`` text, written by each package)."""
    import json
    import shutil
    import sys

    from lsdm_tpu.run import scene_completion as jax_cli
    from lsdm_tpu.train import state as jax_state
    from lsdm_tpu_torch.fitting.meshio import load_obj, write_obj
    from lsdm_tpu_torch.run import scene_completion
    from lsdm_tpu_torch.weights import atiss_state_dict_from_jax

    seed = 5
    create_train_state = jax_state.create_train_state
    rs = np.random.RandomState(0)
    box = np.array([[x, y, z] for x in (-0.3, 0.3) for y in (-0.2, 0.2)
                    for z in (0.0, 0.7)], np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2], [4, 6, 5], [5, 6, 7]])

    def obj(path, verts):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_obj(str(path), verts, faces)

    fit = tmp_path / "fit"
    obj(fit / "fit_best_obj" / "table" / "0" / "box" / "opt_best.obj", box)
    (fit / "fit_best_obj" / "table" / "0" / "best_obj_id.json").write_text(
        json.dumps({"best_obj_id": "box"}))
    for i in range(16):
        obj(fit / "human" / "mesh" / f"{i:03d}.obj", box * 0.5 + [1.0 + 0.1 * i, 0.5, 0.0])
    for name in scene_completion.OBJECT_TYPES[::2]:
        for j in range(4):
            obj(tmp_path / "lib" / name / f"m{j}.obj",
                (box * rs.uniform(0.2, 0.6, 3)).astype(np.float32))
    shutil.copytree(fit, tmp_path / "fit_port")

    common = ["--obj_dataset_path", str(tmp_path / "lib"), "--seed", str(seed),
              "--num_iter", "2"]
    monkeypatch.setattr(sys, "argv", ["scene_completion", "--fitting_results_path",
                                      str(fit)] + common)
    seeded = []  # the weights JAX's CLI seeds, as it hands them to its train state
    monkeypatch.setattr(jax_state, "create_train_state",
                        lambda variables, *a, **kw: seeded.append(variables)
                        or create_train_state(variables, *a, **kw))
    capsys.readouterr()
    jax_cli.main()
    jax_log = capsys.readouterr().out
    sd = atiss_state_dict_from_jax(jax.tree.map(np.asarray, seeded[0]["params"]))
    torch.save({"model_state_dict": sd}, tmp_path / "atiss.pt")
    written = scene_completion.main(["--fitting_results_path", str(tmp_path / "fit_port"),
                                     "--path_to_model", str(tmp_path / "atiss.pt"),
                                     "--device", "cpu"] + common)
    port_log = capsys.readouterr().out

    def sampled(log):
        return [line.split()[-1] for line in log.splitlines() if "sampled class" in line]

    assert sampled(port_log) == sampled(jax_log) and len(sampled(jax_log)) == 2
    rel = sorted(os.path.relpath(p, tmp_path / "fit_port") for p in written)
    want = sorted(str(p.relative_to(fit)) for p in fit.glob("fit_best_obj/*/*/*/opt_best.obj")
                  if json.loads((p.parent.parent / "best_obj_id.json").read_text()
                                ).get("no_contact"))
    assert rel == want and len(want) == 2, (rel, want)
    for r in rel:
        got_v, got_f = load_obj(str(tmp_path / "fit_port" / r))
        want_v, want_f = load_obj(str(fit / r))
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got_f, want_f)
