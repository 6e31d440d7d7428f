"""One ``train_baseline`` step of the port's ATISS / MIME against the JAX
package on the CPU, in float64: ``run/_baseline_common.py:baseline_step``
(MSE sizes + MSE translations + cross-entropy, then AdamW) against JAX's
loss under ``value_and_grad`` and ``optax.adamw``, at the tiny widths of
``_torch_atiss_common.py`` (2 layers, hidden 32, 4 heads, ff 64; ResNet18's
topology is fixed, at B = 2 on 64 x 64 masks).  Tolerance F64_TOL *
max(1, |JAX|) elementwise, JAX's attention taken without its float32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_atiss_common import (
    C, F64_TOL, _boxes, _close, _f64_tree, _jax, _jax_model, _port64, _setup, _torch,
    use_float64_attention)
from lsdm_tpu_torch.run._baseline_common import baseline_step
from lsdm_tpu_torch.train.state import create_train_state
from lsdm_tpu_torch.weights import atiss_state_dict_from_jax


@pytest.fixture(autouse=True)
def _float64_attention(monkeypatch):
    use_float64_attention(monkeypatch)


def _jax_baseline_loss(jm, params, batch_stats, boxes, gt_tr, gt_sz, target_cat):
    """The loss of ``lsdm_tpu/run/_baseline_common.py:135-158``."""
    vs = {"params": params}
    if batch_stats:
        vs["batch_stats"] = batch_stats
    out = jm.apply(vs, boxes)
    pred_sizes = jnp.concatenate([out.sizes_x, out.sizes_y, out.sizes_z], -1)[:, 0]
    pred_tr = jnp.concatenate([out.translations_x, out.translations_y,
                               out.translations_z], -1)[:, 0]
    logits = out.class_labels[:, 0]
    ce = -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits, -1),
                                       jnp.argmax(target_cat, -1)[:, None], 1))
    return (jnp.mean((pred_sizes - gt_sz) ** 2) + jnp.mean((pred_tr - gt_tr) ** 2)
            + ce)


@pytest.mark.parametrize("variant", ["base", "quirk", "mime_resnet"])
def test_train_step_equals_jax_in_float64(variant):
    """One ``train_baseline`` step in float64: the loss, every gradient
    leaf (the angle head's, which the loss never reads, zero) and every
    parameter after AdamW (lr 1e-3, weight decay 0.01) against
    ``value_and_grad`` and ``optax.adamw``; the trainer's ``*_tr`` targets
    are ones.  "base": padded slots, the simple extractor; "quirk": the
    batch-axis attention over ResNet18, whose frozen BatchNorms' weight and
    bias train; "mime_resnet": MIME's bias-free ``contact_fc`` over
    ResNet18.  Readings: loss up to 1.5e-16, gradients up to 2.5e-15,
    parameters up to 8.3e-12.  A key bias's gradient is zero in exact
    arithmetic, rounding on each side, which Adam scales into updates of
    ~1e-12, so the parameters are held at F64_TOL too."""
    jm, variables, port = _setup(variant)
    b = _boxes(contact=variant.startswith("mime"))
    for k, w in (("class_labels_tr", C), ("translations_tr", 3), ("sizes_tr", 3),
                 ("angles_tr", 1)):
        b[k] = np.ones((2, 1, w), np.float32)
    rs = np.random.RandomState(4)
    gt_tr, gt_sz = rs.randn(2, 3), rs.rand(2, 3)
    tcat = np.eye(13)[[2, 7]]
    lr = 1e-3
    tx = optax.adamw(lr, weight_decay=0.01)
    with jax.enable_x64(True):
        jm64 = _jax_model(variant, jnp.float64)
        p64 = _f64_tree(variables["params"])
        bs64 = _f64_tree(variables.get("batch_stats", {}))
        args = (_jax(b, jnp.float64),) + tuple(jnp.asarray(a, jnp.float64)
                                               for a in (gt_tr, gt_sz, tcat))

        @jax.jit
        def step(p):
            loss, grads = jax.value_and_grad(
                lambda p: _jax_baseline_loss(jm64, p, bs64, *args))(p)
            updates, _ = tx.update(grads, tx.init(p), p)
            return loss, grads, optax.apply_updates(p, updates)

        loss, grads, new = jax.tree.map(np.asarray, step(p64))
    port64 = _port64(variant)
    state = create_train_state(port64, lr=lr, weight_decay=0.01)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    got = baseline_step(state, _torch(b, torch.float64), t(gt_tr), t(gt_sz), t(tcat))
    _close(got, loss, F64_TOL, "loss")
    want_g = atiss_state_dict_from_jax(grads, dtype=torch.float64)
    want_p = atiss_state_dict_from_jax(new, dtype=torch.float64)
    for name, p in port64.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _close(g, want_g[name], F64_TOL, f"grad {name}")
        _close(p, want_p[name], F64_TOL, f"param {name}")
