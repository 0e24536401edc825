"""The port's ScorePosNet (eager) and its kernel-backed forward (plain
versions on the CPU) against the JAX package's XLA forward
(DiffusionModel.apply) and its Pallas fast path in interpret mode, with
weights bridged from the JAX parameters. Tolerances are those between the
JAX package's own kernels and XLA (tests/test_fast_forward.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.models.score_model import DiffusionModel as JaxDiffusionModel
from targetdiff_tpu_torch.data.batch import from_numpy
from targetdiff_tpu_torch.models.score_model import DiffusionModel, ScorePosNet
from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict
from tests.test_fast_forward import NUM_CLASSES, PROTEIN_DIM, batch_mult8, small_flagship

torch.set_num_threads(2)

POS_TOL = dict(atol=2e-4, rtol=1e-3)
LOGIT_TOL = dict(atol=2e-3, rtol=1e-2)


def small_setup(**cfg_overrides):
    """(config, JAX model, JAX params, JAX batch, port model, port batch)
    for the flagship architecture at small width (H=32, 4 heads, K=8, L=2)."""
    cfg = small_flagship()
    cfg.update(cfg_overrides)
    jbatch = batch_mult8()
    jmodel = JaxDiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, max_protein=16, max_ligand=8)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch)
    model = DiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, device="cpu",
                           max_protein=16, max_ligand=8)
    model.net.load_state_dict(flax_params_to_state_dict(jax.device_get(params)))
    batch = from_numpy(*[np.asarray(a) for a in jbatch])
    return cfg, jmodel, params, jbatch, model, batch


def assert_ligand_close(port_out, jax_out, lmask):
    np.testing.assert_allclose(port_out["pred_ligand_pos"].numpy() * lmask,
                               np.asarray(jax_out["pred_ligand_pos"]) * lmask, **POS_TOL)
    np.testing.assert_allclose(port_out["pred_ligand_v"].numpy() * lmask,
                               np.asarray(jax_out["pred_ligand_v"]) * lmask, **LOGIT_TOL)


@pytest.mark.parametrize("path", ["eager", "kernel_backed"])
def test_forward_matches_jax_xla_and_pallas(path):
    _, jmodel, params, jbatch, model, batch = small_setup()
    t = jnp.array([3, 7])
    ref_xla = jmodel.apply(params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, t)
    ref_pl = jmodel.fast_apply(params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, t,
                               dtype=jnp.float32, interpret=True)
    with torch.no_grad():
        if path == "eager":
            out = model.apply(batch, batch.ligand_pos, batch.ligand_v)
        else:
            out = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v,
                                   dtype=torch.float32)
    lmask = np.asarray(jbatch.ligand_mask)[..., None]
    assert_ligand_close(out, ref_xla, lmask)
    assert_ligand_close(out, ref_pl, lmask)
    assert np.isfinite(out["pred_ligand_v"].numpy()).all()


@pytest.mark.parametrize("override", [dict(cutoff_mode="radius"), dict(ew_net_type="r"),
                                      dict(x2h_out_fc=True), dict(time_emb_dim=4),
                                      dict(num_r_gaussian=16)])
def test_unsupported_config_raises(override):
    """A config the JAX package does not build (a radius cutoff) or whose
    RBF width breaks the reference's MLPs raises; the options off the
    kernels (ew_net_type r, the x2h output MLP, a time embedding) build the
    eager network, and the kernel paths refuse them with their reason
    (their parity with JAX: tests/test_torch_uni_o2_variants.py)."""
    from targetdiff_tpu_torch.models.fast_forward import require_kernels

    cfg = small_flagship()
    cfg.update(override)
    if "cutoff_mode" in override or "num_r_gaussian" in override:
        with pytest.raises(NotImplementedError):
            ScorePosNet(cfg, PROTEIN_DIM, NUM_CLASSES)
        return
    model = DiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, device="cpu", max_protein=16,
                           max_ligand=8)
    assert model.impl == "eager"
    with pytest.raises(ValueError, match="impl='eager'"):
        require_kernels(cfg)
