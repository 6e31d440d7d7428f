"""The port's (data, model) mesh on CPU gloo ranks against its single-process
step and against the JAX package's sharded programs.

Four ranks, started once for the file (``parallel.mesh.spawn``, a file
rendezvous in a temporary directory), each run every check at JAX's
``TINY`` configuration (``tests/test_parallel.py:17-20``) on a global batch
of 8 scenes whose object masks differ from scene to scene
(``mask[b, 1:2 + 3 * b % (O - 1)] = 1``, no two alike): the SDM reads the mask across the batch
axis (its head-major tiling and its ``(N, -1, B, O)`` scramble), which
JAX's own tests, with one mask for every scene, cannot see.

* The sharded train step at meshes 2x1, 1x2 and 2x2 against the
  single-process step from the same weights and draws: in float64 (the
  chamfer too: ``_torch_parallel_ranks.float64_losses``) the loss, every
  gradient leaf and every parameter within 1e-9 relative; in float32 the
  loss within rtol 1e-5 and the parameters within atol 1e-5 (JAX's bounds,
  ``tests/test_parallel.py:134,137``) where Adam's first step is well
  conditioned (gradient >= ``dryrun.WELL_CONDITIONED``: below it a
  rounding of the gradient moves an entry by a share of the learning
  rate, and at this configuration the float32 backbone gradients, 1e-7
  and below at the seeded start, are rounded 2e-4 of their leaf apart by
  the float32 step itself against the float64 one).  Parameters and
  statistics are bitwise equal on every rank.
* The 2x2 float32 loss against JAX's loss at mesh (4, 2) on the 8 virtual
  CPU devices, from the same weights (the port's, converted by JAX's
  ``convert_torch_state_dict``) and JAX's train-step draws, rtol 1e-4.
* Sharded sampling at 4x1 (the fused encode's and K6's chain's plain
  versions, T = 8) against JAX's sharded sampling at (8, 1) with the
  inputs of ``test_sharded_sampling_equals_single_device`` but per-scene
  masks, the same weights and the same noise, atol 2e-5.
* The traps: the same float64 step with each rank reading the mask as if
  its rows were the whole batch gives another loss and other gradients;
  with every gradient counted once a model rank, the gradients alone
  show it.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from lsdm_tpu.config import SDMConfig
from lsdm_tpu.diffusion import make_schedule as jax_make_schedule
from lsdm_tpu.diffusion import training_losses as jax_training_losses
from lsdm_tpu.models.sampling import sample_sdm as jax_sample_sdm
from lsdm_tpu.models.sdm import SceneDiffusionModel as JaxSDM
from lsdm_tpu.parallel import mesh as jax_mesh
from lsdm_tpu.train.checkpoint import convert_torch_state_dict
from lsdm_tpu_torch.config import SDMConfig as PortConfig
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.parallel import dryrun, mesh
from lsdm_tpu_torch.weights import init_weights

TINY = SDMConfig(**dryrun.TINY)
B, T = 8, 8
O, N = TINY.max_objs, TINY.pcd_points
MESHES = ["2x1", "1x2", "2x2"]


def _jax_draws(key):
    """JAX's train step's draws (``lsdm_tpu/train/trainer.py``: t and noise
    from ``split(key, 3)``), and the head's keep-mask from the third key."""
    t_key, noise_key, drop_key = jax.random.split(key, 3)
    return {"t": np.asarray(jax.random.randint(t_key, (B,), 0, T)),
            "noise": np.asarray(jax.random.normal(noise_key, (B, N, 3))),
            "keep": np.asarray(jax.random.uniform(drop_key, (B * O, N, 128)) < 0.5)}


def _sample_setup():
    """``test_sharded_sampling_equals_single_device``'s inputs with
    per-scene masks, and JAX's sampler draws from its key 11."""
    ks = jax.random.split(jax.random.PRNGKey(3), 5)
    inputs = {"mask": dryrun.scene_inputs(TINY, B, 0)["mask"],
              "objs": np.asarray(jax.random.normal(ks[1], (B, O, N, 3))),
              "cats": np.asarray(jax.nn.one_hot(jnp.zeros((B, O), jnp.int32), 13)),
              "text": np.asarray(jax.random.normal(ks[3], (B, TINY.clip_dim)))}
    step_key, init_key = jax.random.split(jax.random.PRNGKey(11))
    x_init = np.asarray(jax.random.normal(init_key, (B, N, 3), jnp.float32))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(step_key, i), (B, N, 3), jnp.float32)) for i in range(T)])
    return inputs, x_init, noise


def _jax_sharded_sample(variables, inputs):
    model = JaxSDM(TINY)
    sched = jax_make_schedule("cosine", T)

    def run(m, o, c, t):
        s, last = jax_sample_sdm(model, variables, sched, m, o, c, t,
                                 jax.random.PRNGKey(11), clip_denoised=False)
        return s, last.cat

    mesh8 = jax_mesh.make_mesh((8, 1))
    with mesh8, jax.default_matmul_precision("highest"):
        args = jax_mesh.shard_batch(mesh8, tuple(
            jnp.asarray(inputs[k]) for k in ("mask", "objs", "cats", "text")))
        s, cat = jax.jit(run)(*args)
    return np.asarray(s), np.asarray(cat)


def _jax_sharded_loss(variables, inputs, draws):
    """JAX's train-mode loss at mesh (4, 2) with ``obj_sharding`` (the
    backbone's clouds split over both axes), flax's Dropout applying the
    given keep-mask."""
    mesh8 = jax_mesh.make_mesh((4, 2))
    model = JaxSDM(TINY, obj_sharding=jax_mesh.obj_sharding(mesh8))
    sched = jax_make_schedule("cosine", T)
    keep = jnp.asarray(draws["keep"])

    def dropout(self, x, deterministic=None, rng=None):
        if self.rate == 0.0 or deterministic or (
                deterministic is None and self.deterministic):
            return x
        return jnp.where(keep, x / (1.0 - self.rate), 0.0)

    def loss_fn(v, mask, objs, cats, target, target_cat, text, t, noise):
        def model_fn(x_t, tt):
            out, _ = model.apply(v, x_t, mask, tt, objs, cats, text, True,
                                 mutable=["batch_stats"])
            return out
        return jax_training_losses(sched, model_fn, target, t, target_cat,
                                   noise)["loss"]

    put = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                   jax_mesh.batch_sharding(mesh8, np.ndim(a)))
    args = [put(inputs[k]) for k in dryrun.INPUTS] + [put(draws["t"]),
                                                     put(draws["noise"])]
    v = jax.device_put(variables, jax_mesh.replicated(mesh8))
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(fnn.Dropout, "__call__", dropout)
        return float(jax.jit(loss_fn)(v, *args))


@pytest.fixture(scope="module")
def run():
    port = init_weights(SceneDiffusionModel(PortConfig(**dryrun.TINY)), 0)
    weights = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = convert_torch_state_dict(weights)
    inputs = dryrun.scene_inputs(PortConfig(**dryrun.TINY), B, 0)
    draws = _jax_draws(jax.random.PRNGKey(2))
    variables = {"params": params, "batch_stats": stats}
    s_inputs, x_init, noise = _sample_setup()
    sample_args = dict(batch=B, T=T, weights=weights, inputs=s_inputs,
                       x_init=x_init, noise=noise, ball_impl="fused",
                       fused_step="chain")
    started = mesh.start_ranks(ranks.worker, 4,
                               (dryrun.TINY, weights, inputs, draws, sample_args),
                               timeout=900)
    try:  # JAX's programs while the ranks run
        jax_loss = _jax_sharded_loss(variables, inputs, draws)
        jax_sample = _jax_sharded_sample(variables, s_inputs)
    except BaseException:
        started.kill()
        raise
    return {"ranks": started.wait(), "jax_loss": jax_loss, "jax_sample": jax_sample}


@pytest.mark.parametrize("shape,kind", [(m, "float64") for m in MESHES]
                         + [("2x2", "float64_alt")])
def test_sharded_step_equals_single_process_float64(run, shape, kind):
    """``float64_alt``: a DGCNN + P2R model (``pcd_backbone_type``,
    ``human_backbone_type``), whose BatchNorms also take the global
    batch's statistics (the P2R tower's over the data axis) and whose
    object backbone drops out twice; at 2x2 both axes split."""
    got = run["ranks"][0][kind]
    single, sharded = got["single"]["metrics"], got[shape]["metrics"]
    for k in ("loss", "mse", "cat_loss", "grad_norm"):
        np.testing.assert_allclose(sharded[k], single[k], rtol=1e-9, err_msg=k)
    assert got[shape]["grad_err"] <= 1e-9, got[shape]["grad_worst"]
    # every entry, relative to the largest parameter entry of the model
    assert got[shape]["param_err_all"] <= 1e-9


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_step_equals_single_process_float32(run, shape):
    """JAX's bounds on the loss and the parameters; and every gradient leaf
    within 5e-3 of its 2-norm (``chip_smoke.py:MESH_GRAD_RTOL``; read
    3.6e-5 at 2x1 and 1x2, 1.3e-3 at 2x2), which the planted faults
    exceed."""
    got = run["ranks"][0]["float32"]
    np.testing.assert_allclose(got[shape]["metrics"]["loss"],
                               got["single"]["metrics"]["loss"], rtol=1e-5)
    assert got[shape]["param_err"] <= 1e-5
    assert got[shape]["grad_err"] <= 5e-3, got[shape]["grad_worst"]


@pytest.mark.parametrize("shape", MESHES)
def test_parameters_bitwise_equal_across_ranks(run, shape):
    """As JAX's ``is_fully_replicated``: one digest of every parameter and
    statistic on every rank of the mesh, in both precisions."""
    for dtype in ("float32", "float64"):
        digests = {r[dtype][shape]["digest"] for r in run["ranks"] if shape in r[dtype]}
        members = sum(shape in r[dtype] for r in run["ranks"])
        assert members == int(shape[0]) * int(shape[2]) and len(digests) == 1


def test_sharded_loss_equals_jax_sharded_loss(run):
    np.testing.assert_allclose(run["ranks"][0]["float32"]["2x2"]["metrics"]["loss"],
                               run["jax_loss"], rtol=1e-4)


def test_sharded_sampling_equals_jax(run):
    want, want_cat = run["jax_sample"]
    for r in run["ranks"]:
        got = r["sample"]
        assert got["path"] == ("fused", "chain")
        np.testing.assert_allclose(got["sharded"].numpy(), want, atol=2e-5)
        np.testing.assert_allclose(got["cat"].numpy(), want_cat, atol=2e-5)
        np.testing.assert_allclose(got["sharded"].numpy(), got["single"].numpy(),
                                   atol=2e-5)


def test_mask_read_per_rank_gives_another_loss(run):
    """Without the global mask, a rank's scene b, head h takes the mask
    row (b * H + h) mod B_rank of its own rows instead of the global
    batch's, and its scramble reads its own rows: another function.  At
    the seeded start the loss moves little (1.4e-7 of it, where the right
    step reads within 1e-15); the gradients move by a fifth of a leaf
    (0.18)."""
    got = run["ranks"][0]["faults"]
    single = got["single"]["metrics"]["loss"]
    assert abs(got["2x1 local_mask"]["metrics"]["loss"] - single) > 1e-7 * abs(single)
    assert got["2x1 local_mask"]["grad_err"] > 1e-2


def test_gradients_counted_per_model_rank_show_in_the_gradients_alone(run):
    """The trap of a gather's backward: each rank of a model-axis line backs
    up the same loss, so without the division by the line's length every
    gradient is counted once a rank (twice at 1x2).  The loss is the
    single process's, and Adam's first step, which moves an entry by about
    lr * sign(g), leaves the parameters within the float32 check's 1e-5
    of the right ones where the gradient is well conditioned: only the
    gradients show it, a whole leaf off."""
    got = run["ranks"][0]["faults"]
    fault, single = got["1x2 model_axis"], got["single"]["metrics"]
    np.testing.assert_allclose(fault["metrics"]["loss"], single["loss"], rtol=1e-9)
    np.testing.assert_allclose(fault["metrics"]["grad_norm"], 2 * single["grad_norm"],
                               rtol=1e-9)
    assert abs(fault["grad_err"] - 1.0) <= 1e-9
    assert fault["param_err"] <= 1e-5


# --- the mesh's pieces in one process ---------------------------------------

def test_single_process_mesh():
    m = mesh.make_mesh()
    assert (m.shape, m.ranks, m.data_index, m.model_index) == ((1, 1), (0,), 0, 0)
    with pytest.raises(ValueError, match="mesh shape"):
        mesh.make_mesh((2, 1))
    assert mesh.batch_sharding(m, 8) == slice(0, 8) and m.size == 1
    x = torch.arange(8.0)
    got = mesh.shard_batch(m, {"a": x, "b": [x, x[:4]]})
    assert torch.equal(got["a"], x) and torch.equal(got["b"][1], x[:4])
    assert torch.equal(mesh.cloud_shard_map(lambda t: 2 * t, m, x), 2 * x)


@pytest.mark.parametrize("impl,want", [("fused", "auto"), ("sg", "auto"),
                                       ("pallas", "pallas"), ("auto", "auto")])
def test_sharded_config_resolves_as_jax(impl, want):
    """JAX's ``models/sdm.py:141-143``: the whole-stage and select-gather
    kernels give way to the per-shard selection under an object sharding."""
    cfg = dataclasses.replace(PortConfig(**dryrun.TINY), ball_impl=impl)
    assert mesh.sharded_config(cfg).ball_impl == want


def test_object_split_refuses_fused_stages():
    model = SceneDiffusionModel(dataclasses.replace(PortConfig(**dryrun.TINY),
                                                    ball_impl="fused"))
    x = dryrun._tensors(dryrun.scene_inputs(model.cfg, 2, 0), "cpu", torch.float32)
    with pytest.raises(ValueError, match="sharded_config"):
        model.encode_conditioning(x["mask"], x["objs"], x["cats"], x["text"],
                                  shard=mesh.BatchShard(mesh.make_mesh()))

