"""``Model.loss`` and its gradient through the port, against
``jax.value_and_grad(model.loss)`` of the JAX package on the same weights,
for every architecture of ``ARCH_IDS`` at ``reduced()`` (the vlm batch with
patches, whisper's with frames); the gradients with and without ``remat``;
and the loss metric of the eval step.  Held in float32 to ``atol=1e-4,
rtol=1e-3``, the tolerance of ``test_torch_models_smoke.py``."""

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.models import Model
from repro_torch.training import loss_and_grads, make_eval_step
from repro_torch.training.optimizer import tree_leaves
from test_torch_models_smoke import _batch, _models

TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    jmodel, jparams, tmodel, tparams = _models(arch)
    jb, tb = _batch(tmodel.cfg, 2, 32)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jb)
    loss, metrics, grads = loss_and_grads(tmodel, tparams, tb)
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    for key in jmetrics:
        np.testing.assert_allclose(metrics[key].numpy(), np.asarray(jmetrics[key]), **TOL)
    want = jax.tree.leaves(jgrads)
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), **TOL)
    # the eval step reports the same metrics, with no gradient
    evaluated = make_eval_step(tmodel)(tparams, tb)
    for key in metrics:
        torch.testing.assert_close(evaluated[key], metrics[key], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["minicpm_2b", "mamba2_130m", "zamba2_2p7b", "mixtral_8x22b",
                                  "deepseek_v3_671b", "whisper_small"])
def test_remat_gives_the_same_gradients(arch):
    """``torch.utils.checkpoint`` around each layer body recomputes the
    same activations: the loss and every gradient leaf are bit for bit
    those without remat."""
    _, _, model, params = _models(arch)
    _, tb = _batch(model.cfg, 2, 32)
    assert model.remat  # the default, as in the JAX package
    loss, _, grads = loss_and_grads(model, params, tb)
    plain = Model(model.cfg, device="cpu", remat=False)
    loss0, _, grads0 = loss_and_grads(plain, params, tb)
    assert torch.equal(loss, loss0)
    for g, g0 in zip(tree_leaves(grads), tree_leaves(grads0)):
        assert torch.equal(g, g0)
