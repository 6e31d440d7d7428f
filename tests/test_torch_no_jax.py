"""lsdm_tpu_torch must run without JAX: the machine with the GPU has none.

A fresh interpreter imports every module of the port (``train/``,
``utils/logger.py``, ``run/train_sdm.py``, ``run/scene_edit.py``,
``profile_train.py``, the editing ops, the DGCNN and STGCN backbones,
``fitting/`` and the fitting CLIs included) and ``chip_smoke.py``,
samples at a tiny size on the CPU with the composed and the fused encode,
the chain and the step sampler, runs the ``test_sdm`` (both samplers),
``scene_edit`` (a keyword hit: ICP) and ``train_sdm`` entry points on a
synthetic split and the editing metrics, samples a DGCNN + P2R model, runs
``fit_custom_obj`` and ``gen_human_meshes``, the contact-semantics entry
points ``train_contactformer`` (on a synthetic contact split) and
``predict_contact``, and the viewers ``vis_fitting_results`` and
``vis_dataset`` (``--no_png --html``), and then must hold no ``jax``,
``jaxlib``, ``flax`` or ``optax`` module, and nothing of the JAX package
``lsdm_tpu``.
"""

import subprocess
import sys
from pathlib import Path

_SCRIPT = r"""
import dataclasses, importlib, os, pkgutil, shutil, sys, tempfile
import numpy as np
import torch
import lsdm_tpu_torch
for m in pkgutil.walk_packages(lsdm_tpu_torch.__path__, "lsdm_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke

from lsdm_tpu_torch import SDMConfig
from lsdm_tpu_torch.diffusion.schedule import make_schedule
from lsdm_tpu_torch.models.sampling import sample_sdm
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.weights import init_weights

cfg = SDMConfig(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4,
                vert_dims=24, pcd_points=32)
model = init_weights(SceneDiffusionModel(cfg), 0).eval()
g = torch.Generator().manual_seed(0)
mask = torch.zeros(1, 9)
mask[:, 1:3] = 1.0
cats = torch.nn.functional.one_hot(torch.randint(0, 13, (1, 9), generator=g), 13)
fused = SceneDiffusionModel(dataclasses.replace(cfg, ball_impl="fused"))
fused.load_state_dict(model.state_dict())
for m, step in ((model, "chain"), (model, None), (fused.eval(), "chain"),
                (fused, "step")):
    sample, out = sample_sdm(m, make_schedule("cosine", 3), mask,
                             torch.randn(1, 9, 32, 3, generator=g), cats.float(),
                             torch.randn(1, 32, generator=g), generator=g,
                             fused_step=step)
    assert sample.shape == (1, 32, 3) and torch.isfinite(sample).all()

from lsdm_tpu_torch.data.synthetic import generate
from lsdm_tpu_torch.run import test_sdm
with tempfile.TemporaryDirectory() as d:
    data = generate(d, "proxd", n_scenes=1, n_seqs=2, pnt_size=32, split="test")
    test_sdm.main([data, "--objs_data_dir", os.path.join(d, "objs"),
                   "--output_dir", os.path.join(d, "out"), "--device", "cpu",
                   "--pcd_points", "32", "--diffusion_steps", "2",
                   "--ball_impl", "fused"])
    test_sdm.main([data, "--objs_data_dir", os.path.join(d, "objs"),
                   "--output_dir", os.path.join(d, "out_step"), "--device", "cpu",
                   "--pcd_points", "32", "--diffusion_steps", "2", "--fused_step"])
    ctx = os.path.join(data, "context")
    for s in os.listdir(ctx):
        lines = open(os.path.join(ctx, s)).readlines()
        lines[0] = "place a desk next to the person\n"
        open(os.path.join(ctx, s), "w").writelines(lines)
    os.makedirs(os.path.join(d, "objs", "N3Office"))
    np.save(os.path.join(d, "objs", "N3Office", "table_0.npy"),
            np.random.RandomState(0).rand(32, 3).astype(np.float32))
    from lsdm_tpu_torch.run import scene_edit
    final = scene_edit.main([data, "--objs_data_dir", os.path.join(d, "objs"),
                             "--output_dir", os.path.join(d, "edit"), "--device", "cpu",
                             "--pcd_points", "32", "--diffusion_steps", "2",
                             "--icp_tries", "4"])
    assert "fitness" in final, final
from lsdm_tpu_torch.ops import geometry, metrics, recon_metrics, rotations
x = torch.randn(2, 16, 3, generator=g)
assert torch.isfinite(metrics.emd_sinkhorn(x, x.flip(1), iters=5))
assert float(recon_metrics.compute_iou(x[..., 0] > 0, x[..., 1] > 0)) >= 0
assert rotations.rotz(torch.zeros(2)).shape == (2, 3, 3)
assert np.isfinite(geometry.estimate_floor_height(x.numpy()))
from lsdm_tpu_torch.run import train_sdm
with tempfile.TemporaryDirectory() as d:
    data = generate(d, "proxd", n_scenes=1, n_seqs=2, pnt_size=32, split="train")
    train_sdm.main(["--train_data_dir", data, "--objs_data_dir", os.path.join(d, "objs"),
                    "--save_dir", os.path.join(d, "out"), "--device", "cpu",
                    "--pcd_points", "32", "--diffusion_steps", "2", "--epochs", "1",
                    "--batch_size", "2", "--ball_impl", "sg", "--attn_impl", "pallas"])
# the alternate backbones: a DGCNN + P2R model samples on the chain
alt = SceneDiffusionModel(dataclasses.replace(cfg, pcd_backbone_type="DGCNN",
                                              human_backbone_type="P2R"))
sample, _ = sample_sdm(init_weights(alt, 0).eval(), make_schedule("cosine", 3), mask,
                       torch.randn(1, 9, 32, 3, generator=g), cats.float(),
                       torch.randn(1, 32, generator=g), generator=g, fused_step="chain")
assert sample.shape == (1, 32, 3) and torch.isfinite(sample).all()
# the fitting CLIs: a box library, a short human sequence, a predicted cloud
from lsdm_tpu_torch.fitting.meshio import write_obj
from lsdm_tpu_torch.run import fit_custom_obj, gen_human_meshes
with tempfile.TemporaryDirectory() as d:
    os.makedirs(os.path.join(d, "lib", "table"))
    box = np.array([[x, y, z] for x in (-0.3, 0.3) for y in (-0.2, 0.2)
                    for z in (0.0, 0.7)], np.float32)
    write_obj(os.path.join(d, "lib", "table", "box.obj"), box)
    rs = np.random.RandomState(0)
    np.save(os.path.join(d, "verts.npy"), rs.rand(8, 64, 3).astype(np.float32))
    np.save(os.path.join(d, "pred.npy"), rs.rand(40, 3).astype(np.float32))
    res = fit_custom_obj.main(["--file_name", os.path.join(d, "pred.npy"),
                               "--label", "table", "--vertices_path",
                               os.path.join(d, "verts.npy"), "--obj_lib",
                               os.path.join(d, "lib"), "--output_dir",
                               os.path.join(d, "fit"), "--sdf_dim", "16",
                               "--device", "cpu"])
    assert res and np.isfinite(res[0]["loss"]), res
    gen_human_meshes.main(["--vertices_path", os.path.join(d, "verts.npy"),
                           "--output_dir", os.path.join(d, "meshes")])
    from lsdm_tpu_torch.run import vis_fitting_results
    fit = os.path.join(d, "fit", "fit_best_obj")
    shutil.copytree(os.path.join(d, "lib", "table"), os.path.join(fit, "t", "0", "box"))
    os.rename(os.path.join(fit, "t", "0", "box", "box.obj"),
              os.path.join(fit, "t", "0", "box", "opt_best.obj"))
    out = vis_fitting_results.main(["--fitting_results_path", os.path.join(d, "fit"),
                                    "--vertices_path", os.path.join(d, "verts.npy"),
                                    "--no_png", "--html"])
    assert os.path.exists(os.path.join(out, "scene.html"))
# the contact-semantics entry points and the dataset viewer
from lsdm_tpu_torch.run import predict_contact, train_contactformer, vis_dataset
with tempfile.TemporaryDirectory() as d:
    contact = chip_smoke.contact_split(os.path.join(d, "contact"), n_seqs=2,
                                       frames=24, nv=16)
    res = train_contactformer.main(["--train_data_dir", contact, "--save_dir",
                                    os.path.join(d, "cf"), "--epochs", "1",
                                    "--steps_per_epoch", "1", "--max_frame", "8",
                                    "--mesh_ds_dir", os.path.join(d, "none"),
                                    "--decoder_mode", "4", "--device", "cpu"])
    assert np.isfinite(res["loss"]), res
    assert os.path.exists(os.path.join(d, "cf", "best_model_recon_acc.pt"))
    out = vis_dataset.main(["--data_dir", contact, "--seq_name", "seq0",
                            "--save_dir", os.path.join(d, "vis"), "--no_png", "--html"])
    assert os.listdir(out) == ["scene.html"]
    data = generate(d, "proxd", n_scenes=1, n_seqs=1, pnt_size=1024, split="test")
    written = predict_contact.main([data, "--objs_data_dir", os.path.join(d, "objs"),
                                    "--output_dir", os.path.join(d, "pred"),
                                    "--diffusion_steps", "2", "--device", "cpu"])
    assert len(written) == 1 and np.isfinite(np.load(written[0])).all()
frameworks = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not frameworks, frameworks
ours = sorted(m for m in sys.modules if m.split(".")[0] == "lsdm_tpu")
assert not ours, ours
print("ok")
"""


_ATISS_SCRIPT = r"""
import json, os, sys, tempfile
import numpy as np
import torch
import chip_smoke
from lsdm_tpu_torch.data.synthetic import generate
from lsdm_tpu_torch.fitting.meshio import write_obj
from lsdm_tpu_torch.run import (generate_scenes, get_next_obj_class, scene_completion,
                                test_cf_atiss, train_atiss, train_contactformer)
with tempfile.TemporaryDirectory() as d:
    train = generate(d, "proxd", n_scenes=1, n_seqs=4, pnt_size=1024, split="train")
    test = generate(d, "proxd", n_scenes=1, n_seqs=2, pnt_size=1024, split="test")
    objs = os.path.join(d, "objs")
    train_atiss.main(["--train_data_dir", train, "--objs_data_dir", objs, "--save_dir",
                      os.path.join(d, "atiss"), "--epochs", "1", "--batch_size", "2",
                      "--device", "cpu"])
    contact = chip_smoke.contact_split(os.path.join(d, "contact"), n_seqs=1, frames=24,
                                       nv=16)
    train_contactformer.main(["--train_data_dir", contact, "--save_dir",
                              os.path.join(d, "cf"), "--epochs", "1", "--steps_per_epoch",
                              "1", "--max_frame", "8", "--mesh_ds_dir",
                              os.path.join(d, "none"), "--device", "cpu"])
    final = test_cf_atiss.main([test, "--objs_data_dir", objs, "--output_dir",
                                os.path.join(d, "cf_eval"), "--cf_ckpt",
                                os.path.join(d, "cf", "best_model_recon_acc.pt"),
                                "--device", "cpu"])
    assert np.isfinite(list(final.values())).all(), final
    written = generate_scenes.main(["--load_model", os.path.join(d, "atiss",
                                    "final_atiss.pt"), "--n_scenes", "1", "--max_boxes",
                                    "4", "--output_dir", os.path.join(d, "gen"),
                                    "--device", "cpu"])
    assert len(written) == 1
    out = get_next_obj_class.main(["--device", "cpu"])
    assert 0 <= out["class"] < 23 and len(out["translation"]) == 3
    # a fitted table and a short human sequence; chair / sofa / table candidates
    box = np.array([[x, y, z] for x in (-0.3, 0.3) for y in (-0.2, 0.2)
                    for z in (0.0, 0.7)], np.float32)

    def obj(path, verts):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_obj(path, verts)

    fit = os.path.join(d, "fit", "fit_best_obj", "table", "0")
    obj(os.path.join(fit, "box", "opt_best.obj"), box)
    json.dump({"best_obj_id": "box"}, open(os.path.join(fit, "best_obj_id.json"), "w"))
    for i in range(3):
        obj(os.path.join(d, "fit", "human", "mesh", f"{i:03d}.obj"), box * 0.5 + 1.0)
    for name in ("chair", "sofa", "table", "desk", "stool", "wardrobe"):
        obj(os.path.join(d, "lib", name, "a.obj"), box * 0.3)
    placed = scene_completion.main(["--fitting_results_path", os.path.join(d, "fit"),
                                    "--obj_dataset_path", os.path.join(d, "lib"),
                                    "--num_iter", "2", "--device", "cpu"])
    assert len(placed) == 2 and all(os.path.exists(p) for p in placed), placed
frameworks = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not frameworks, frameworks
ours = sorted(m for m in sys.modules if m.split(".")[0] == "lsdm_tpu")
assert not ours, ours
print("ok")
"""


_FINISHED_SCRIPT = r"""
import importlib, os, sys, tempfile
import numpy as np
import torch
import chip_smoke
NEW = ["lsdm_tpu_torch.parallel", "lsdm_tpu_torch.parallel.mesh",
       "lsdm_tpu_torch.parallel.dryrun", "lsdm_tpu_torch.data.threed_front",
       "lsdm_tpu_torch.data.threed_front_dataset", "lsdm_tpu_torch.data.threed_front_scene",
       "lsdm_tpu_torch.run.train_atiss_3dfront", "lsdm_tpu_torch.utils.fixseed",
       "lsdm_tpu_torch.utils.profiling", "lsdm_tpu_torch.tools.pickle_amass_vertices",
       "lsdm_tpu_torch.data.npy_native"]
for name in NEW:
    importlib.import_module(name)
from lsdm_tpu_torch.data import npy_native
from lsdm_tpu_torch.parallel import dryrun, mesh
from lsdm_tpu_torch.run import train_atiss_3dfront
from lsdm_tpu_torch.utils.fixseed import fixseed
from lsdm_tpu_torch.utils.profiling import device_memory_stats, trace
g = fixseed(0)
with tempfile.TemporaryDirectory() as d:
    np.save(os.path.join(d, "a.npy"), np.arange(6, dtype=np.float32))
    assert (npy_native.load(os.path.join(d, "a.npy")) == np.arange(6)).all()
    with trace(os.path.join(d, "trace")):
        torch.randn(8, 8, generator=g).sum()
    assert os.path.exists(os.path.join(d, "trace", "trace.json"))
    # a cached 3D-FRONT split: 3 rooms of 3-5 boxes of 5 classes
    chip_smoke.threed_front_cache(d, rooms=3)
    state = train_atiss_3dfront.main([
        "--dataset_directory", os.path.join(d, "cache"), "--annotation_file",
        os.path.join(d, "splits.csv"), "--train_stats", "stats.json",
        "--room_layout_size", "32,32", "--feature_extractor", "simple",
        "--n_layers", "1", "--dim_ff", "32", "--batch_size", "2", "--epochs", "1",
        "--steps_per_epoch", "1", "--save_dir", os.path.join(d, "out"),
        "--device", "cpu"])
    assert state.step == 1
# the sharded train step on two gloo ranks
res = mesh.spawn(dryrun.train_check, 2, (dryrun.TINY, [(2, 1)]), timeout=480)
assert res[0]["2x1"]["digest"] == res[1]["2x1"]["digest"]
assert device_memory_stats() == {} or torch.cuda.is_available()
frameworks = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
assert not frameworks, frameworks
ours = sorted(m for m in sys.modules if m.split(".")[0] == "lsdm_tpu")
assert not ours, ours
print("ok")
"""


def test_finished_port_runs_without_jax():
    """The last modules of the port with no JAX module loaded: each of the
    eleven imported by name, ``fixseed``, ``npy_native``, ``trace``,
    ``train_atiss_3dfront`` for one step on a cached 3D-FRONT split, and
    the sharded train step on two CPU gloo ranks."""
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", _FINISHED_SCRIPT], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


def test_atiss_entry_points_run_without_jax():
    """The ATISS / MIME entry points on the CPU with no JAX module loaded:
    ``train_atiss`` on a synthetic split, ``test_cf_atiss`` with a
    ContactFormer ``.pt`` of ``train_contactformer`` as ``--cf_ckpt``,
    ``generate_scenes`` from the trained ``.pt``, ``get_next_obj_class``,
    and ``scene_completion`` on a tiny fitting directory (two objects
    placed)."""
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", _ATISS_SCRIPT], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


def test_port_imports_and_samples_without_jax():
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
