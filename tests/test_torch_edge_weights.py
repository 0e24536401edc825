"""The edge-weight kernel's algorithm (targetdiff_tpu_torch/csrc/block_denoiser.cu
ew_kernel) replayed in plain PyTorch on the CPU: the graph's slots in tiles of
32, each slot's distance and RBF row [rbf | 1 | 0 ...] (one lane per slot, the
bias b1 as the row's constant column), the first layer as three-term TF32
products over 8-deep k-steps (lo*hi + hi*lo + hi*hi, each k-step summed from
zero, k ascending), then per slot the LayerNorm, ReLU, the dot with w2 and
the sigmoid. The replay is held against float64 and against the JAX XLA
edge-weight MLP (`edge_pred_layer`, targetdiff_tpu/models/uni_transformer.py)
with the weights carried over by the bridge (utils/port.py), on kNN graphs of
K = 8 and 32 and on a hybrid graph, at the bar the kernel is held to on the
card (chip_smoke.EW_TOL: 1e-5 absolute on the valid slots); one TF32 product
per term misses it. The kernel wrappers refuse CPU tensors."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.models.common import MLP as JaxMLP
from targetdiff_tpu.ops.rbf import gaussian_smearing as jax_smearing
from targetdiff_tpu.ops.rbf import gaussian_smearing_offsets as jax_offsets
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
from targetdiff_tpu_torch.ops.kernels import block_vjp
from targetdiff_tpu_torch.ops.rbf import gaussian_smearing_offsets
from tests.test_torch_block_vjp import _split_setup
from tests.test_torch_weight_grad import split3

torch.set_num_threads(2)

EW_BAR = 1e-5  # chip_smoke.EW_TOL, absolute on the valid slots
TILE, KSTEP, K_PAD = 32, 8, 24  # slots per warp step; m16n8k8 depth; R + 1 padded
# cutoff mode, knn, protein slots, ligand slots: kNN K = 8 and 32, hybrid
# K = ligand slots - 1 + knn = 15
CASES = {"knn_K8": ("knn", 8, 16, 8), "knn_K32": ("knn", 32, 40, 8),
         "hybrid_K15": ("hybrid", 8, 16, 8)}


def ew_replay(x, nbh, packed_ew, terms=3):
    """e_w [B,N,K] as ew_kernel computes it from positions x [B,N,3] and
    `pack_block_params`' edge-weight weights (w1 [R,H], b1 [H], ln [2,H], w2
    [H], b2 [1]); terms=1: one TF32 product (hi*hi) per term."""
    w1, b1, ln, w2, b2 = packed_ew
    R, H = w1.shape
    offsets, coeff = gaussian_smearing_offsets()
    B, N, K = nbh.idx.shape
    E = B * N * K
    # one lane per slot: its distance and RBF row, in tiles of 32 slots
    src = (nbh.idx + N * torch.arange(B)[:, None, None]).reshape(-1)
    rel = x.reshape(-1, 3).repeat_interleave(K, 0) - x.reshape(-1, 3)[src]
    dist = torch.sqrt(rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1] + rel[:, 2] * rel[:, 2]
                      + 1e-16)
    tiles = -(-E // TILE)
    a = torch.zeros(tiles * TILE, K_PAD)
    d = dist[:, None] - offsets
    a[:E, :R] = torch.exp(coeff * d * d)
    a[:E, R] = 1.0
    w = torch.zeros(K_PAD, H)
    w[:R], w[R] = w1, b1
    # the first layer: per 8-deep k-step three TF32 products summed from zero
    ah, al = split3(a.reshape(-1, K_PAD // KSTEP, KSTEP))
    bh, bl = split3(w.reshape(K_PAD // KSTEP, KSTEP, H))

    def prod(p, q):  # [E, ks, 8] x [ks, 8, H] -> [E, ks, H]
        return torch.einsum("eki,kih->ekh", p, q)

    z = prod(ah, bh) if terms == 1 else prod(al, bh) + prod(ah, bl) + prod(ah, bh)
    acc = z[:, 0]
    for k in range(1, K_PAD // KSTEP):
        acc = acc + z[:, k]
    mean = acc.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((acc - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    y = torch.relu((acc - mean) * rstd * ln[0] + ln[1])
    logit = (y * w2).sum(-1) + b2
    return torch.sigmoid(logit)[:E].reshape(B, N, K)


def _case(case):
    """The small flagship (H = 32) of tests/test_torch_block_vjp.py on the
    case's graph: (JAX params, torch refine_net, x, nbh, packed weights)."""
    _, _, params, _, _, _, rn, _, x, _, nbh, _, _, _ = _split_setup(*CASES[case])
    with torch.no_grad():
        packed = kblock.pack_block_params(rn)
    return params, rn, x, nbh, packed


@pytest.mark.parametrize("case", list(CASES))
def test_edge_weight_replay_holds_the_float64_bar(case):
    """The kernel's algorithm within EW_BAR of the module's edge weights in
    float64 on every valid slot (and finite on every slot), as close as the
    plain float32 version is, to a few times its own error."""
    _, rn, x, nbh, packed = _case(case)
    K = nbh.idx.shape[-1]
    assert K == {"knn_K8": 8, "knn_K32": 32, "hybrid_K15": 15}[case]
    with torch.no_grad():
        got = ew_replay(x, nbh, packed.ew)
        want = copy.deepcopy(rn).double().edge_weights(x.double(), nbh)[..., 0]
        plain = rn.edge_weights(x, nbh)[..., 0]
    assert bool(got.isfinite().all())
    err = float((got.double() - want)[nbh.mask].abs().max())
    plain_err = float((plain.double() - want)[nbh.mask].abs().max())
    assert err < EW_BAR and err < max(10 * plain_err, 1e-6), (err, plain_err)


@pytest.mark.parametrize("case", list(CASES))
def test_edge_weight_replay_matches_jax_edge_pred_layer(case):
    """The replay against the JAX XLA edge-weight MLP (MLP(1, hidden) of
    targetdiff_tpu.models.common, the refine_net's `edge_pred_layer` params)
    on the JAX package's RBF features of the same distances, within EW_BAR
    on the valid slots: the bridge carried the weights over."""
    params, _, x, nbh, packed = _case(case)
    H = packed.ew[0].shape[1]
    rel = x[:, :, None] - G.gather_nodes(x, nbh.idx)
    dist = np.sqrt((rel.numpy() ** 2).sum(-1) + 1e-16)
    offsets, coeff = jax_offsets(0.0, 10.0, 20)
    logits = JaxMLP(1, H, norm=True, act_fn="relu").apply(
        {"params": jax.device_get(params)["params"]["refine_net"]["edge_pred_layer"]},
        jax_smearing(jnp.asarray(dist, jnp.float32), offsets, coeff))
    want = np.asarray(jax.nn.sigmoid(logits))[..., 0]
    with torch.no_grad():
        got = ew_replay(x, nbh, packed.ew).numpy()
    m = nbh.mask.numpy()
    assert float(np.abs(got - want)[m].max()) < EW_BAR


def test_one_term_edge_weight_replay_misses_the_bar():
    """One TF32 product per term in the first layer lands well outside the bar
    that the three-term replay holds on the same slots."""
    _, rn, x, nbh, packed = _case("knn_K32")
    with torch.no_grad():
        want = copy.deepcopy(rn).double().edge_weights(x.double(), nbh)[..., 0]
        three = ew_replay(x, nbh, packed.ew)
        one = ew_replay(x, nbh, packed.ew, terms=1)
    m = nbh.mask
    assert float((three.double() - want)[m].abs().max()) < EW_BAR
    assert float((one.double() - want)[m].abs().max()) > 2 * EW_BAR


def test_edge_weight_and_node_bwd_kernels_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: on the CPU they raise and
    launch nothing (the plain versions serve the CPU)."""
    _, rn, x, nbh, packed = _case("knn_K8")
    with pytest.raises(ValueError, match="CUDA"):
        kblock.edge_weights_cuda(x, nbh, packed)
    H, V, rows = 128, 16, 8
    rowbuf = torch.zeros(rows, block_vjp.row_layout(H, V)["width"])
    with pytest.raises(ValueError, match="CUDA"):
        block_vjp.node_bwd_cuda(rowbuf, torch.zeros(rows, H), torch.zeros(rows, H),
                                torch.zeros(2, H), torch.zeros(H, H), torch.zeros(5 * H, H))
    assert kblock.EW_LAUNCHES == 0 and block_vjp.NODE_BWD_LAUNCHES == 0
