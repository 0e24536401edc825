"""The sampler's dependency cone (targetdiff_tpu_torch/ops/kernels/cone.py)
and the block that computes only its rows, on the CPU.

The cone's hops against a brute-force breadth-first search; its live rows
inside the tiles JAX's `compute_tile_flags(..., num_layers=L)` marks live
(TI = 8, 32), and equal to them at tiles of one row, where JAX's last-layer
v9 rule is the rule of hop <= 1; both also at the kernel's edge shapes (K =
1, n_ligand = N, a fully masked complex; L = 1 and 29). A `ConeWorkspace`
reused at three batch sizes gives a fresh call's Cone. The plain block with the cone
(`block_forward(..., cone=...)`, the plain version of the block kernels'
row lists) with every row outside a layer's set poisoned to NaN after the
layer: its ligand outputs stay finite and equal to the all-live block's,
bit for bit. The port's `fast_forward(need_full_h=False)` against JAX's
`fast_forward(mode='mega', need_full_h=False)` in interpret mode, at the
JAX suite's tolerances (tests/test_fast_forward.py). The callers: sampling
and the likelihood compute a cone, the embedding export and training do
not. The node kernel's walk over a row list (`node_walk(..., lists=...)`)
covers each position of the list once. Inputs are numpy arrays from seeds;
weights are torch-seeded (the poison test) or JAX's, bridged."""

import functools
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.data.batch import ComplexBatch
from targetdiff_tpu.models.score_model import DiffusionModel as JaxDiffusionModel
from targetdiff_tpu.ops.pallas.block_denoiser import compute_tile_flags, pick_tile
from targetdiff_tpu_torch.data.batch import from_numpy
from targetdiff_tpu_torch.models import fast_forward as ff
from targetdiff_tpu_torch.models.score_model import DiffusionModel
from targetdiff_tpu_torch.models.uni_transformer import AttentionLayerO2TwoUpdateNodeGeneral
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
from targetdiff_tpu_torch.ops.kernels import cone as kcone
from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict
from tests.test_fast_forward import NUM_CLASSES, PROTEIN_DIM, small_flagship

torch.set_num_threads(2)

POS_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_fast_forward.py:65-73
LOGIT_TOL = dict(atol=2e-3, rtol=1e-2)
L_CONE = 3
B_CONE, NP_CONE, NL_CONE = 2, 96, 8  # N = 104: the cone skips most protein rows at L = 3


def bfs_hops(idx, mask, n_ligand, L):
    """hop [B, N] by a breadth-first search from the ligand-tail rows over
    the edges d -> s (row d lists s as a valid neighbour), capped: rows
    farther than L + 1, or unreached, get L + 2."""
    B, N, K = idx.shape
    out = np.full((B, N), L + 2, np.int64)
    for b in range(B):
        dist = [None] * N
        todo = deque()
        for r in range(N - n_ligand, N):
            dist[r] = 0
            todo.append(r)
        while todo:
            d = todo.popleft()
            for k in range(K):
                s = int(idx[b, d, k])
                if mask[b, d, k] and dist[s] is None:
                    dist[s] = dist[d] + 1
                    todo.append(s)
        out[b] = [L + 2 if v is None or v > L + 1 else v for v in dist]
    return out


def graph(kind, seed, B=3, NP=56, NL=8, K=8):
    """A graph of B complexes of NP + NL rows: 'knn', the kNN graph of
    scattered protein atoms (some padded) and ligands at the centre (complex
    1's ligand one valid atom), or 'random', random neighbour lists with
    random masks and fully masked rows. Returns (idx int64, mask bool) numpy
    arrays and NL."""
    rng = np.random.default_rng(seed)
    N = NP + NL
    if kind == "random":
        idx = rng.integers(0, N, (B, N, K))
        mask = rng.random((B, N, K)) < 0.7
        mask[:, rng.integers(0, N, 6)] = False
        return idx, mask, NL
    pos = np.concatenate([rng.uniform(-8, 8, (B, NP, 3)), rng.normal(size=(B, NL, 3))], 1)
    node_mask = np.ones((B, N), bool)
    node_mask[0, NP - 5:NP] = False
    node_mask[1, NP + 1:] = False
    node_mask[2, NP + 5:] = False
    nbh = G.knn_graph(torch.tensor(pos, dtype=torch.float32), torch.tensor(node_mask), K)
    return nbh.idx.numpy(), nbh.mask.numpy(), NL


GRAPHS = [("knn", 0), ("knn", 1), ("random", 2), ("random", 3)]


def edge_graph(case, seed=7):
    """The kernel's edge shapes as random graphs: 'k1' one slot a row,
    'ligand_only' n_ligand = N (every row hop 0), 'dead' a complex whose
    slots are all masked (only its ligand tail is reached). Returns (idx,
    mask, n_ligand)."""
    K, NP, NL = (1, 56, 8) if case == "k1" else (8, 0, 24) if case == "ligand_only" else (8, 56, 8)
    idx, mask, _ = graph("random", seed, NP=NP, NL=NL, K=K)
    if case == "dead":
        mask[1] = False
    return idx, mask, NL


EDGE_CASES = ["k1", "ligand_only", "dead"]


@pytest.mark.parametrize("L", [1, 3, 9])
@pytest.mark.parametrize("kind,seed", GRAPHS)
def test_cone_hops_match_breadth_first_search(kind, seed, L):
    idx, mask, NL = graph(kind, seed)
    got = kcone.cone_hops_plain(torch.tensor(idx), torch.tensor(mask), NL, L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), bfs_hops(idx, mask, NL, L))


@pytest.mark.parametrize("L", [1, 29])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_cone_hops_match_breadth_first_search_at_edge_shapes(case, L):
    idx, mask, NL = edge_graph(case)
    got = kcone.cone_hops_plain(torch.tensor(idx), torch.tensor(mask), NL, L).numpy()
    want = bfs_hops(idx, mask, NL, L)
    np.testing.assert_array_equal(got, want)
    if case == "ligand_only":
        assert (got == 0).all()
    if case == "dead":
        assert (got[1, :-NL] == L + 2).all() and (got[1, -NL:] == 0).all()


@pytest.mark.parametrize("kind,seed", GRAPHS + [(case, None) for case in EDGE_CASES])
def test_cone_order_is_a_stable_sort_with_counts(kind, seed):
    idx, mask, NL = graph(kind, seed) if seed is not None else edge_graph(kind)
    cone = kcone.block_cone(torch.tensor(idx), torch.tensor(mask), NL, L_CONE)
    hop = cone.hop.numpy().reshape(-1)
    np.testing.assert_array_equal(cone.order.numpy(), np.argsort(hop, kind="stable"))
    np.testing.assert_array_equal(cone.counts.numpy(),
                                  [(hop <= k).sum() for k in range(L_CONE + 2)])
    for l in range(L_CONE):
        np.testing.assert_array_equal(np.sort(cone.x2h_rows(l).numpy()),
                                      np.flatnonzero(hop <= L_CONE - l))
        np.testing.assert_array_equal(np.sort(cone.node_rows(l).numpy()),
                                      np.flatnonzero(hop <= L_CONE - l + 1))


def jax_live_tiles(idx, mask, NL, L, tile):
    """JAX's per-layer x2h tile flags [B, L, T] and the tile width."""
    B, N, _ = idx.shape
    flags = np.asarray(compute_tile_flags(jnp.asarray(idx), jnp.asarray(mask), NL, tile=tile,
                                          rtile=tile, num_layers=L))
    TI = pick_tile(N, tile)
    T = N // TI
    return flags[:, -L * T:].reshape(B, L, T).astype(bool), TI


@pytest.mark.parametrize("tile", [8, 32])
@pytest.mark.parametrize("kind,seed", GRAPHS)
def test_cone_rows_lie_in_jax_live_tiles(kind, seed, tile):
    idx, mask, NL = graph(kind, seed)
    hop = kcone.cone_hops_plain(torch.tensor(idx), torch.tensor(mask), NL, L_CONE).numpy()
    live, TI = jax_live_tiles(idx, mask, NL, L_CONE, tile)
    assert TI == tile
    for l in range(L_CONE):
        rows_live = hop <= L_CONE - l
        tile_of_row = np.repeat(live[:, l], TI, axis=1)
        assert not (rows_live & ~tile_of_row).any(), f"layer {l}: a live row in a dead tile"
    assert not (hop <= 1).all()  # the last layer's rows are not every row


@pytest.mark.parametrize("kind,seed", GRAPHS)
def test_cone_equals_jax_flags_at_one_row_tiles(kind, seed):
    """At tiles of one row JAX's tile sweeps are the row rule: its per-layer
    flags equal hop <= L - l, and its v9 last-x2h flags (num_layers=None)
    equal hop <= 1, the rule of layer L - 1."""
    idx, mask, NL = graph(kind, seed)
    hop = kcone.cone_hops_plain(torch.tensor(idx), torch.tensor(mask), NL, L_CONE).numpy()
    live, TI = jax_live_tiles(idx, mask, NL, L_CONE, 1)
    assert TI == 1
    for l in range(L_CONE):
        np.testing.assert_array_equal(live[:, l], hop <= L_CONE - l)
    N = idx.shape[1]
    v9 = np.asarray(compute_tile_flags(jnp.asarray(idx), jnp.asarray(mask), NL, tile=1,
                                       rtile=1))[:, -N:].astype(bool)
    np.testing.assert_array_equal(v9, hop <= 1)


@pytest.mark.parametrize("L", [1, 29])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_cone_equals_jax_flags_at_one_row_tiles_at_edge_shapes(case, L):
    """At the edge shapes JAX's per-layer flags at one-row tiles equal hop <=
    L - l, layer by layer, up to L = 29 (MAX_LAYERS)."""
    idx, mask, NL = edge_graph(case)
    hop = kcone.cone_hops_plain(torch.tensor(idx), torch.tensor(mask), NL, L).numpy()
    live, TI = jax_live_tiles(idx, mask, NL, L, 1)
    assert TI == 1
    for l in range(L):
        np.testing.assert_array_equal(live[:, l], hop <= L - l)


@pytest.mark.parametrize("kind,seed", GRAPHS)
def test_cone_workspace_gives_a_fresh_calls_cone(kind, seed):
    """Three calls in a row at different B through one ConeWorkspace: each
    Cone equals a fresh call's and lives in the workspace's buffer, which
    the first (largest) call allocated and the others reuse."""
    idx, mask, NL = graph(kind, seed)
    ws = kcone.ConeWorkspace()
    buffer = None
    for b in (3, 1, 2):
        args = (torch.tensor(idx[:b]), torch.tensor(mask[:b]), NL, L_CONE)
        got, want = kcone.block_cone(*args, workspace=ws), kcone.block_cone(*args)
        buffer = ws.buffer if buffer is None else buffer
        assert ws.buffer is buffer
        for name, g, w in zip(want._fields, got, want):
            assert torch.equal(g, w), (b, name)
            assert g.untyped_storage().data_ptr() == buffer.untyped_storage().data_ptr()
    assert kcone.block_cone(*args, workspace=ws).hop.data_ptr() == got.hop.data_ptr()


def cone_batch(seed=0):
    """A JAX ComplexBatch of B_CONE complexes: NP_CONE protein atoms scattered
    over a 18 A cube (complex 0 padded by 6), NL_CONE ligand slots at the
    centre (complex 1's ligand 5 atoms)."""
    rng = np.random.default_rng(seed)
    pmask = np.ones((B_CONE, NP_CONE), bool)
    pmask[0, NP_CONE - 6:] = False
    lmask = np.ones((B_CONE, NL_CONE), bool)
    lmask[1, 5:] = False
    return ComplexBatch(
        jnp.asarray(rng.uniform(-9, 9, (B_CONE, NP_CONE, 3)).astype(np.float32)),
        jnp.asarray((rng.random((B_CONE, NP_CONE, PROTEIN_DIM)) > 0.7).astype(np.float32)),
        jnp.asarray(pmask),
        jnp.asarray(rng.normal(size=(B_CONE, NL_CONE, 3)).astype(np.float32)),
        jnp.asarray(rng.integers(0, NUM_CLASSES, (B_CONE, NL_CONE)).astype(np.int32)),
        jnp.asarray(lmask))


def cone_config():
    cfg = small_flagship()
    cfg.update(dict(num_layers=L_CONE))
    return cfg


@functools.lru_cache(maxsize=None)
def jax_setup():
    """(JAX model, its params, the JAX batch, the port model with the same
    weights, the port batch)."""
    cfg, jbatch = cone_config(), cone_batch()
    jmodel = JaxDiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, max_protein=NP_CONE,
                               max_ligand=NL_CONE)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch)
    model = DiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, device="cpu", max_protein=NP_CONE,
                           max_ligand=NL_CONE)
    model.net.load_state_dict(flax_params_to_state_dict(jax.device_get(params)))
    return jmodel, params, jbatch, model, from_numpy(*[np.asarray(a) for a in jbatch])


def port_setup():
    """The port model with torch-seeded weights, the block's inputs (h, x,
    the kNN graph, the ligand mask) and the graph's cone."""
    torch.manual_seed(0)
    model = DiffusionModel(cone_config(), PROTEIN_DIM, NUM_CLASSES, device="cpu",
                           max_protein=NP_CONE, max_ligand=NL_CONE)
    batch = from_numpy(*[np.asarray(a) for a in cone_batch(1)])
    with torch.no_grad():
        h, x, node_mask, mlig = model.net.embed(
            batch.protein_pos, batch.protein_feat, batch.protein_mask, batch.ligand_pos,
            batch.ligand_v, batch.ligand_mask)
    nbh = G.knn_graph(x, node_mask, model.net.refine_net.k)
    return model, h, x, nbh, mlig, kcone.block_cone(nbh.idx, nbh.mask, NL_CONE, L_CONE)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_poisoned_rows_never_reach_the_ligand_outputs(dtype, monkeypatch):
    """Rows outside each layer's set (and, before layer 0, outside its node
    rows) set to NaN: the cone block's x and ligand h stay finite and equal
    the all-live block's bit for bit, and the poison is really there."""
    model, h, x, nbh, mlig, cone = port_setup()
    rn = model.net.refine_net
    B, N, H = h.shape
    with torch.no_grad():
        h_ref, x_ref = kblock.block_denoiser(rn, h, x, nbh, mlig, NL_CONE, dtype=dtype)

    def poison(t, rows):
        dead = torch.ones(B * N, dtype=torch.bool)
        dead[rows] = False
        t = t.reshape(B * N, -1).clone()
        t[dead] = float("nan")
        return t.view(B, N, -1)

    original = AttentionLayerO2TwoUpdateNodeGeneral.forward_rows

    def poisoned(self, h, x, edge_attr, nbh, mask_ligand, e_w, rows, lig_rows, dtype):
        h, x = original(self, h, x, edge_attr, nbh, mask_ligand, e_w, rows, lig_rows, dtype)
        return poison(h, rows), x

    monkeypatch.setattr(AttentionLayerO2TwoUpdateNodeGeneral, "forward_rows", poisoned)
    with torch.no_grad():
        h_c, x_c = kblock.block_denoiser(rn, poison(h, cone.node_rows(0)), x, nbh, mlig,
                                         NL_CONE, dtype=dtype, cone=cone)
    lig = slice(N - NL_CONE, N)
    assert torch.isfinite(x_c).all() and torch.isfinite(h_c[:, lig]).all()
    assert torch.equal(x_c, x_ref)
    assert torch.equal(h_c[:, lig], h_ref[:, lig])
    skipped = int(torch.isnan(h_c[..., 0]).sum())
    assert skipped > B * N // 2, f"only {skipped} rows were poisoned"


def test_cone_refused_with_fixed_coordinates():
    model, h, x, nbh, mlig, cone = port_setup()
    with pytest.raises(ValueError, match="fix_x"):
        kblock.block_denoiser(model.net.refine_net, h, x, nbh, mlig, NL_CONE, fix_x=True,
                              cone=cone)


def test_fast_forward_cone_matches_jax_need_full_h_false():
    """Positions and type logits of the port's need_full_h=False forward
    against JAX's in interpret mode, at the JAX suite's tolerances; and the
    port's ligand outputs with the cone equal its all-live outputs bit for
    bit, float32 and bf16."""
    jmodel, params, jbatch, model, batch = jax_setup()
    ref = jmodel.fast_apply(params, jbatch, jbatch.ligand_pos, jbatch.ligand_v,
                            dtype=jnp.float32, interpret=True, mode="mega", need_full_h=False)
    with torch.no_grad():
        out = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, dtype=torch.float32,
                               need_full_h=False)
    lmask = np.asarray(jbatch.ligand_mask)[..., None]
    np.testing.assert_allclose(out["pred_ligand_pos"].numpy() * lmask,
                               np.asarray(ref["pred_ligand_pos"]) * lmask, **POS_TOL)
    np.testing.assert_allclose(out["pred_ligand_v"].numpy() * lmask,
                               np.asarray(ref["pred_ligand_v"]) * lmask, **LOGIT_TOL)
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            full = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, dtype=dtype)
            cone = model.fast_apply(batch, batch.ligand_pos, batch.ligand_v, dtype=dtype,
                                    need_full_h=False)
        for key in ("pred_ligand_pos", "pred_ligand_v", "final_ligand_h"):
            assert torch.equal(cone[key], full[key]), (dtype, key)
        assert not torch.equal(cone["final_h"], full["final_h"])  # protein rows went stale


def test_callers_pass_need_full_h(monkeypatch):
    """Sampling steps and the likelihood compute one cone a forward (the
    last block's, need_full_h=False, as JAX score_model.py:426 and :498);
    the embedding export (fix_x) and training keep every row."""
    _, _, _, model, batch = jax_setup()
    calls = []

    def recorded(*args, **kw):
        calls.append(args[3])
        return kcone.block_cone(*args, **kw)

    monkeypatch.setattr(ff, "block_cone", recorded)
    B, NL = batch.ligand_pos.shape[:2]
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn((B, NL, 3), generator=gen)
    uniform = torch.rand((B, NL, NUM_CLASSES), generator=gen)

    def count(fn):
        calls.clear()
        with torch.no_grad():
            fn()
        return list(calls)

    assert count(lambda: model.sample_step(batch, batch.ligand_pos, batch.ligand_v, 5, noise,
                                           uniform, impl="fast")) == [L_CONE]
    assert count(lambda: model.sample_step(batch, batch.ligand_pos, batch.ligand_v, 5, noise,
                                           uniform, impl="fast", s=2, sampler="dpm2",
                                           coefs=(0.5, 0.5, 0.1))) == [L_CONE, L_CONE]
    assert count(lambda: model.likelihood_estimation(
        batch, torch.tensor([3, 7]), pos_noise=noise, v_uniform=uniform, impl="fast")) == [L_CONE]
    assert count(lambda: model.fetch_embedding(batch, impl="fast")) == []
    assert count(lambda: model.fast_apply(batch, batch.ligand_pos, batch.ligand_v)) == []
    calls.clear()
    model.get_diffusion_loss(batch, time_step=torch.tensor([3, 7]), pos_noise=noise,
                             v_uniform=uniform, impl="fast")["loss"].backward()
    assert calls == []


WALK_LISTS = [(64, 200), (8, 8), (1, 1), (4 * 32, 4 * 608), (1157, 60800)]


@pytest.mark.parametrize("lists", WALK_LISTS)
def test_node_walk_over_a_row_list_covers_each_position_once(lists):
    """The node kernel over a row list (td_block_node_list): positions u <
    n_dst get ni and q once, u < n_src nj once, nothing past them; the
    blocks deal the card's `slots` to the groups from the counts on the
    device, every dealt block has work, and the deal fits the grid of
    slots + 3 blocks."""
    n_dst, n_src = lists
    for slots, warpgroups in ((264, 1), (132, 2), (3, 1), (7, 2)):
        seen = np.zeros((3, n_src), np.int64)
        blocks = kblock.node_walk(1, n_src, 0, slots, warpgroups, lists=lists)
        assert len(blocks) <= slots + 3
        for grp, walks in blocks:
            assert len(walks[0]) > 0
            for rows in walks:
                for r in rows:
                    np.add.at(seen[grp], r, 1)
        want = np.zeros_like(seen)
        want[1] = 1
        want[0, :n_dst] = want[2, :n_dst] = 1
        np.testing.assert_array_equal(seen, want)
