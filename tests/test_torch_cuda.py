"""The CUDA kernels against their plain PyTorch versions on the card, at
the released widths (hidden 128, 16 heads, 20 RBF knots) with small node
counts, including K < 32 and masked rows. Marked `cuda`: each test skips
unless a CUDA device is present. On a GPU host, run
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q`
(the suite's conftest imports jax, which GPU hosts need not have)."""

import numpy as np
import pytest
import torch

from targetdiff_tpu_torch.config import Config
from targetdiff_tpu_torch.data.batch import from_numpy
from targetdiff_tpu_torch.models.score_model import DiffusionModel
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
from targetdiff_tpu_torch.ops.kernels import knn as kknn

pytestmark = pytest.mark.cuda

CONFIG = dict(
    model_mean_type="C0", beta_schedule="sigmoid", beta_start=1e-7, beta_end=2e-3,
    v_beta_schedule="cosine", v_beta_s=0.01, num_diffusion_timesteps=20, center_pos_mode="protein",
    node_indicator=True, model_type="uni_o2", num_blocks=1, num_layers=2, hidden_dim=128,
    n_heads=16, edge_feat_dim=4, num_r_gaussian=20, knn=8, act_fn="relu", norm=True,
    cutoff_mode="knn", ew_net_type="global", num_x2h=1, num_h2x=1, r_max=10.0,
    x2h_out_fc=False, sync_twoup=False,
)
NP_, NL, B = 34, 8, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _complexes(device, seed=0):
    rng = np.random.default_rng(seed)
    pmask = np.ones((B, NP_), bool)
    pmask[0, 30:] = False
    lmask = np.ones((B, NL), bool)
    lmask[1, 5:] = False
    lmask[2, 1:] = False  # a one-atom ligand
    return from_numpy(rng.normal(size=(B, NP_, 3)) * 3, rng.random((B, NP_, 27)) > 0.7, pmask,
                      rng.normal(size=(B, NL, 3)), rng.integers(0, 13, (B, NL)), lmask,
                      device=device)


@pytest.mark.parametrize("k", [1, 8, 32])
def test_knn_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    N = 45
    pos = torch.tensor(rng.normal(size=(B, N, 3)) * 3, dtype=torch.float32, device=cuda)
    mask = torch.ones((B, N), dtype=torch.bool, device=cuda)
    mask[0, 40:] = False
    mask[1, ::5] = False
    mask[2, 10:] = False  # fewer valid atoms than K + 1 when k = 32
    ref = G.knn_graph(pos, mask, k)
    out = kknn.knn_graph(pos, mask, k)
    torch.cuda.synchronize()
    assert torch.equal(out.mask, ref.mask)
    assert torch.equal(torch.where(out.mask, out.idx, -1), torch.where(ref.mask, ref.idx, -1))
    assert bool(((out.idx >= 0) & (out.idx < N)).all())


@pytest.mark.parametrize("k", [8, 32])
def test_block_kernel_matches_plain(cuda, k):
    torch.manual_seed(0)
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda)
    rn = model.net.refine_net
    batch = _complexes(cuda)
    with torch.no_grad():
        h, x, node_mask, mlig = model.net.embed(*batch)
        nbh = G.knn_graph(x, node_mask, k)
        h_ref, x_ref = rn.block_forward(h, x, nbh, mlig)
        h_out, x_out = kblock.block_denoiser(rn, h, x, nbh, mlig, n_ligand=NL)
    torch.cuda.synchronize()
    m = node_mask[..., None]
    torch.testing.assert_close(x_out * m, x_ref * m, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(h_out * m, h_ref * m, atol=2e-3, rtol=1e-2)
    assert bool(x_out.isfinite().all()) and bool(h_out.isfinite().all())
    assert torch.equal(x_out[:, :NP_], x[:, :NP_])  # protein rows never move


def test_kernel_backed_step_matches_eager(cuda):
    torch.manual_seed(0)
    model = DiffusionModel(Config(CONFIG), 27, 13, device=cuda)
    batch = _complexes(cuda, seed=1)
    with torch.no_grad():
        fast = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v)
        ref = model.apply(batch, batch.ligand_pos, batch.ligand_v)
    lm = batch.ligand_mask[..., None]
    torch.testing.assert_close(fast["pred_ligand_pos"] * lm, ref["pred_ligand_pos"] * lm,
                               atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(fast["pred_ligand_v"] * lm, ref["pred_ligand_v"] * lm,
                               atol=2e-3, rtol=1e-2)
    res = model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v,
                                 torch.Generator(device=cuda).manual_seed(0), num_steps=5)
    assert bool(res.pos.isfinite().all())
