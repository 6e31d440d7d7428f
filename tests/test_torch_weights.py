"""The weight bridge and the seeded initialisation of the port.

``state_dict_from_jax`` must be the exact inverse of the JAX package's
``convert_torch_state_dict``: a JAX parameter tree goes into the port
(strict ``load_state_dict``: no missing and no unexpected key) and comes
back out through the converter leaf for leaf, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdm_tpu.config import SDMConfig
from lsdm_tpu.models.sdm import SceneDiffusionModel as JaxSDM
from lsdm_tpu.train.checkpoint import convert_torch_state_dict
from lsdm_tpu_torch.config import SDMConfig as PortConfig
from lsdm_tpu_torch.models.sdm import SceneDiffusionModel
from lsdm_tpu_torch.weights import init_weights, state_dict_from_jax

TINY_KW = dict(clip_dim=32, latent_dim=16, cat_emb=8, n_head=4,
               vert_dims=24, pcd_points=32)
TINY = SDMConfig(**TINY_KW)  # the JAX package's
PORT_TINY = PortConfig(**TINY_KW)  # the port's copy


def _jax_variables(cfg, seed=0):
    """A JAX parameter tree of ``cfg`` with every leaf drawn at random."""
    B, O, N = 1, cfg.max_objs, cfg.pcd_points
    jmodel = JaxSDM(cfg)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((B, N, 3)),
        jnp.zeros((B, O)), jnp.zeros((B,), jnp.int32),
        jnp.zeros((B, O, N, 3)), jnp.zeros((B, O, cfg.max_cats)),
        jnp.zeros((B, cfg.clip_dim)))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: rs.randn(*a.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("max_cats", [13, 11])  # PRO-teXt and HUMANISE heads
def test_state_dict_from_jax_roundtrips_through_the_converter(max_cats):
    import dataclasses

    cfg = dataclasses.replace(TINY, max_cats=max_cats)
    variables = _jax_variables(cfg)
    port = SceneDiffusionModel(dataclasses.replace(PORT_TINY, max_cats=max_cats))
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]),
                         strict=True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = convert_torch_state_dict(sd, max_cats=max_cats)
    for original, back in ((variables["params"], params),
                           (variables["batch_stats"], stats)):
        want = jax.tree_util.tree_leaves_with_path(original)
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert {jax.tree_util.keystr(p) for p, _ in want} == {
            jax.tree_util.keystr(p) for p in got}
        got = {jax.tree_util.keystr(p): v for p, v in got.items()}
        for path, leaf in want:
            np.testing.assert_array_equal(
                np.asarray(got[jax.tree_util.keystr(path)]), leaf,
                err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("preset", ["SDMConfig", "sdm_proxd", "sdm_humanise"])
def test_port_config_copies_the_jax_config(preset):
    """The port's configuration is a copy (it may not import the JAX
    package): every field it has, the JAX one has with the same value."""
    import dataclasses

    from lsdm_tpu import config as jax_config
    from lsdm_tpu_torch import config

    port, ref = getattr(config, preset)(), getattr(jax_config, preset)()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("datatype", ["proxd", "humanise"])
def test_port_category_tables_copy_the_jax_tables(datatype):
    from lsdm_tpu import config as jax_config
    from lsdm_tpu_torch import config

    assert config.categories_for(datatype) == jax_config.categories_for(datatype)


def test_init_weights_is_deterministic_per_seed():
    a = init_weights(SceneDiffusionModel(PORT_TINY), 3).state_dict()
    b = init_weights(SceneDiffusionModel(PORT_TINY), 3).state_dict()
    c = init_weights(SceneDiffusionModel(PORT_TINY), 4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["upsampling_layer.4.weight"],
                           c["upsampling_layer.4.weight"])
    # running statistics start neutral
    assert torch.equal(a["pcd_backbone.bn1.running_var"], torch.ones(128))
