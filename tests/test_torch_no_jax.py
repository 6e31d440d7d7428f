"""lsdm_tpu_torch must run without JAX: the machine with the GPU has none.

A fresh interpreter imports every module of the port, samples at a tiny
size on the CPU with the composed and the fused encode, runs the
``test_sdm`` entry point on a synthetic split, and then must hold no
``jax``, ``jaxlib`` or ``flax`` module, and nothing of the JAX package
``lsdm_tpu``.
"""

import subprocess
import sys
from pathlib import Path

_SCRIPT = r"""
import dataclasses, importlib, os, pkgutil, sys, tempfile
import torch
import lsdm_tpu_torch
for m in pkgutil.walk_packages(lsdm_tpu_torch.__path__, "lsdm_tpu_torch."):
    importlib.import_module(m.name)

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
for m, step in ((model, "chain"), (model, None), (fused.eval(), "chain")):
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
frameworks = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not frameworks, frameworks
ours = sorted(m for m in sys.modules if m.split(".")[0] == "lsdm_tpu")
assert not ours, ours
print("ok")
"""


def test_port_imports_and_samples_without_jax():
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
