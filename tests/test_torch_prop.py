"""The port's affinity-prediction path against the JAX package on the CPU:
MOL2 parsing and the SDF -> MOL2 retry, the ligand property features,
PropPredNet and PropPredNetEnc (every enc_feature_type; encoder K above and
below 32) with weights through the bridge (outputs within 1e-4 relative),
`prop_loss_fn` with JAX's draws and its gradients, the regression metrics,
`collate_prop` and `build_enc_features`, PDBBind processing and the
embedding merge, and the bridge and .npz checkpoints of both models
(tests/test_torch_prop_cli.py holds the CLIs and the prop gate)."""

import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from targetdiff_tpu.chem import mol2 as jmol2
from targetdiff_tpu.chem.sdf import read_sdf as jread_sdf
from targetdiff_tpu.config import Config as JConfig
from targetdiff_tpu.data import datasets as jdatasets
from targetdiff_tpu.data import transforms_prop as jtp
from targetdiff_tpu.models.prop import prop_model as jpm
from targetdiff_tpu.utils import checkpoint as jckpt
from targetdiff_tpu.utils import misc_prop as jmisc
from targetdiff_tpu_torch.chem import mol2
from targetdiff_tpu_torch.chem.sdf import read_sdf
from targetdiff_tpu_torch.config import Config
from targetdiff_tpu_torch.data import datasets
from targetdiff_tpu_torch.data import transforms_prop as tp
from targetdiff_tpu_torch.data.store import RecordStore
from targetdiff_tpu_torch.models.prop import prop_model as pm
from targetdiff_tpu_torch.utils import checkpoint as ckpt
from targetdiff_tpu_torch.utils import misc_prop
from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict, state_dict_to_flax_params
from tests.test_mol2 import ACETAMIDE_MOL2, BENZENE_MOL2

torch.set_num_threads(2)

REL = 1e-4  # outputs against JAX, relative to the output's scale
PROT_DIM, LIG_DIM = 27, 30
EXAMPLE_LIGANDS = ["examples/3ug2_ligand.sdf", "examples/1h36_A_rec_1h36_r88_lig_tt_docked_0.sdf"]
ENC_TYPES = ["nll", "nll_all", "final_h", "pred_ligand_v", "pred_v_entropy_pre",
             "pred_v_entropy_post", "full"]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rel=REL):
    got, want = _np(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


# ---- MOL2 and ligand features -----------------------------------------------------

@pytest.mark.parametrize("text", [BENZENE_MOL2, ACETAMIDE_MOL2], ids=["benzene", "acetamide"])
def test_mol2_parsing_matches_jax(text, tmp_path):
    a, b = mol2.parse_mol2_text(text), jmol2.parse_mol2_text(text)
    assert [(x.z, x.aromatic, x.formal_charge) for x in a.atoms] == \
        [(x.z, x.aromatic, x.formal_charge) for x in b.atoms]
    assert [(x.a1, x.a2, x.order, x.aromatic) for x in a.bonds] == \
        [(x.a1, x.a2, x.order, x.aromatic) for x in b.bonds]
    p = tmp_path / "lig.mol2"
    p.write_text(text)
    da, db = mol2.parse_mol2_file(str(p)), jmol2.parse_mol2_file(str(p))
    assert sorted(da) == sorted(db)
    for k in db:
        np.testing.assert_array_equal(np.asarray(da[k]), np.asarray(db[k]), err_msg=k)


def test_sdf_mol2_retry_matches_jax(tmp_path):
    (tmp_path / "lig.sdf").write_text("garbage\n")
    (tmp_path / "lig.mol2").write_text(BENZENE_MOL2)
    d = mol2.parse_ligand_file(str(tmp_path / "lig.sdf"))
    assert d.get("parsed_from_mol2_fallback")
    assert d["element"].tolist() == jmol2.parse_ligand_file(str(tmp_path / "lig.sdf"))[
        "element"].tolist()
    (tmp_path / "other.sdf").write_text("garbage\n")
    with pytest.raises(Exception):
        mol2.parse_ligand_file(str(tmp_path / "other.sdf"))


@pytest.mark.parametrize("path", EXAMPLE_LIGANDS)
def test_ligand_property_features_match_jax(path):
    from targetdiff_tpu.chem.sdf import parse_sdf_file as jparse
    from targetdiff_tpu.chem.sdf import remove_hydrogens as jremove
    from targetdiff_tpu_torch.chem.sdf import parse_sdf_file, remove_hydrogens

    got = tp.ligand_atom_feature_matrix(remove_hydrogens(read_sdf(path)))
    want = jtp.ligand_atom_feature_matrix(jremove(jread_sdf(path)))
    np.testing.assert_array_equal(got, want)
    lig = parse_sdf_file(path)
    data = {"ligand_element": lig["element"], "ligand_atom_feature": got,
            "ligand_pos": lig["pos"], "ligand_bond_index": lig["bond_index"],
            "ligand_bond_type": lig["bond_type"], "protein_pos": lig["pos"][:3] + 1.0}
    jdata = {k: v.copy() for k, v in data.items()}
    jlig = jparse(path)
    np.testing.assert_array_equal(lig["bond_index"], jlig["bond_index"])
    for port_t, jax_t in ((tp.FeaturizeLigandAtomProp(), jtp.FeaturizeLigandAtomProp()),
                          (tp.EdgeConnection("l2l", 4), jtp.EdgeConnection("l2l", 4)),
                          (tp.EdgeConnection("pl", 2), jtp.EdgeConnection("pl", 2)),
                          (tp.LigandCountNeighbors(), jtp.LigandCountNeighbors())):
        data, jdata = port_t(data), jax_t(jdata)
    assert sorted(data) == sorted(jdata)
    for k in jdata:
        np.testing.assert_array_equal(data[k], jdata[k], err_msg=k)
    assert data["ligand_atom_feature_full"].shape[-1] == LIG_DIM == \
        tp.FeaturizeLigandAtomProp().feature_dim


# ---- the models -------------------------------------------------------------------

def prop_config(knn=8, hidden=32, layers=2, rbf=16, norm=False):
    return dict(hidden_channels=hidden, encoder=dict(
        name="egnn", num_layers=layers, hidden_dim=hidden, edge_dim=0, num_r_gaussian=rbf,
        act_fn="relu", norm=norm, knn=knn, cutoff=10.0))


def _samples(n=3, seed=0, np_range=(30, 44), nl_range=(5, 9), hidden=16):
    """Prop samples with the merged export fields of every enc feature."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        np_, nl = int(rng.integers(*np_range)), int(rng.integers(*nl_range))
        pv = rng.dirichlet(np.ones(13), nl).astype(np.float32)
        out.append({
            "protein_pos": (rng.normal(size=(np_, 3)) * 4).astype(np.float32),
            "protein_atom_feature": (rng.random((np_, PROT_DIM)) > 0.7).astype(np.float32),
            "ligand_pos": rng.normal(size=(nl, 3)).astype(np.float32),
            "ligand_atom_feature_full": rng.random((nl, LIG_DIM)).astype(np.float32),
            "y": np.float32(rng.normal() + 6), "kind": np.int64(i % 3 + 1),
            "nll": rng.normal(size=8).astype(np.float32),
            "nll_all": rng.normal(size=10).astype(np.float32),
            "final_h": rng.normal(size=(np_ + nl, hidden)).astype(np.float32),
            "pred_ligand_v": pv,
            "pred_v_entropy": (-(pv * np.log(pv)).sum(-1)).astype(np.float32)[:, None]})
    return out


def _pair(samples, max_protein, max_ligand, enc_ft=None):
    return (misc_prop.collate_prop(samples, max_protein, max_ligand, enc_feature_type=enc_ft),
            jmisc.collate_prop(samples, max_protein, max_ligand, enc_feature_type=enc_ft))


@pytest.mark.parametrize("knn,norm", [(8, False), (40, False), (8, True)])
def test_prop_pred_net_matches_jax(knn, norm):
    """K = 40 selects the kNN kernel's rounds on the card; here both K run
    the plain graph, bitwise the JAX graph. With norm the encoder's MLPs
    carry LayerNorms: net.0/1/3 in place of net.0/2."""
    batch, jbatch = _pair(_samples(), 48, 10)
    cfg = prop_config(knn=knn, norm=norm)
    jmodel = jpm.PropPredNet(config=cfg, output_dim=3)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch)
    model = pm.PropPredNet(Config(cfg), PROT_DIM, LIG_DIM, output_dim=3)
    model.load_state_dict(flax_params_to_state_dict(jax.device_get(params)))
    with torch.no_grad():
        _close(model(batch), jmodel.apply(params, jbatch))
    assert sorted({k.rsplit(".", 1)[0] for k in model.state_dict() if k.startswith("out")}) == [
        "out.0", "out.2"]
    mlp = {k.rsplit(".", 1)[0] for k in model.state_dict() if ".edge_mlp." in k}
    assert ("encoder.net.0.edge_mlp.net.4" in mlp) == norm == (
        "encoder.net.0.edge_mlp.net.2" not in mlp)


@pytest.mark.parametrize("enc_ft", ENC_TYPES)
@pytest.mark.parametrize("knn", [8, 40])
def test_prop_pred_net_enc_matches_jax(enc_ft, knn):
    samples = _samples()
    batch, jbatch = _pair(samples, 48, 10, enc_ft)
    for a, b in zip(batch, jbatch):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    dims = dict(enc_ligand_dim=0 if batch.enc_ligand_feat is None else
                batch.enc_ligand_feat.shape[-1],
                enc_node_dim=0 if batch.enc_node_feat is None else batch.enc_node_feat.shape[-1],
                enc_graph_dim=0 if batch.enc_graph_feat is None else
                batch.enc_graph_feat.shape[-1])
    cfg = dict(prop_config(knn=knn), encoder=dict(prop_config(knn=knn)["encoder"],
                                                  name="egnn_enc"), **dims)
    jmodel = jmisc.get_prop_model(JConfig(cfg))
    params = jmodel.init(jax.random.PRNGKey(1), jbatch)
    model = misc_prop.get_prop_model(Config(cfg), PROT_DIM, LIG_DIM)
    assert isinstance(model, pm.PropPredNetEnc)
    model.load_state_dict(flax_params_to_state_dict(jax.device_get(params)))
    with torch.no_grad():
        _close(model(batch), jmodel.apply(params, jbatch))


def test_prop_loss_and_grads_match_jax_with_its_draws():
    batch, jbatch = _pair(_samples(4, seed=2), 48, 10)
    cfg = prop_config()
    jmodel = jpm.PropPredNet(config=cfg, output_dim=3)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    key = jax.random.PRNGKey(7)
    (jloss, jpred), grads = jax.jit(jax.value_and_grad(
        lambda p: jpm.prop_loss_fn(jmodel, p, key, jbatch, 0.1), has_aux=True))(params)
    kp, kl = jax.random.split(key)
    noise = (torch.tensor(np.asarray(jax.random.normal(kp, jbatch.protein_pos.shape))),
             torch.tensor(np.asarray(jax.random.normal(kl, jbatch.ligand_pos.shape))))
    model = pm.PropPredNet(Config(cfg), PROT_DIM, LIG_DIM)
    model.load_state_dict(flax_params_to_state_dict(jax.device_get(params)))
    loss, pred = pm.prop_loss_fn(model, batch, 0.1, noise=noise)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= REL * abs(float(jloss))
    _close(pred, jpred)
    want = flax_params_to_state_dict(jax.device_get(grads))
    for name, p in model.named_parameters():
        _close(p.grad, want[name].numpy(), rel=1e-3)
    # drawn from a generator: reproducible, and different from no noise
    g = [float(pm.prop_loss_fn(model, batch, 0.1, generator=torch.Generator().manual_seed(3))[0])
         for _ in range(2)]
    assert g[0] == g[1] != float(pm.prop_loss_fn(model, batch, 0.0, generator=None)[0])


def test_eval_scores_match_the_jax_sklearn_scores():
    rng = np.random.default_rng(4)
    y = rng.normal(size=50)
    p = y + rng.normal(size=50) * 0.5
    p[3] = p[4]  # a tie for the ranks
    got, want = misc_prop.get_eval_scores(p, y), jmisc.get_eval_scores(p, y)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k


@pytest.mark.parametrize("enc_ft", ENC_TYPES)
def test_build_enc_features_match_jax(enc_ft):
    s = _samples(1)[0]
    for a, b in zip(misc_prop.build_enc_features(s, enc_ft), jmisc.build_enc_features(s, enc_ft)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(NotImplementedError):
        misc_prop.build_enc_features(s, "bogus")


# ---- the bridge and checkpoints ----------------------------------------------------

@pytest.mark.parametrize("enc", [False, True])
def test_prop_checkpoints_load_in_both_packages(enc, tmp_path):
    samples = _samples()
    enc_ft = "full" if enc else None
    batch, jbatch = _pair(samples, 48, 10, enc_ft)
    cfg = prop_config()
    if enc:
        cfg = dict(cfg, encoder=dict(cfg["encoder"], name="egnn_enc"),
                   enc_ligand_dim=batch.enc_ligand_feat.shape[-1],
                   enc_node_dim=batch.enc_node_feat.shape[-1],
                   enc_graph_dim=batch.enc_graph_feat.shape[-1])
    jmodel = jmisc.get_prop_model(JConfig(cfg))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(2), jbatch))
    model = misc_prop.get_prop_model(Config(cfg), PROT_DIM, LIG_DIM)
    sd = flax_params_to_state_dict(params)
    model.load_state_dict(sd)
    back = state_dict_to_flax_params(model.state_dict())["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params["params"])
    if enc:
        assert "enc_node.2.weight" in sd and "encoder.net.1.edge_inf.0.weight" in sd
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_checkpoint(jpath, JConfig({"model": cfg}), params)
    fresh = misc_prop.get_prop_model(Config(cfg), PROT_DIM, LIG_DIM)
    fresh.load_state_dict(ckpt.load_checkpoint(jpath)["state_dict"])
    ckpt.save_checkpoint(tpath, Config({"model": cfg}), fresh)
    loaded = jckpt.load_checkpoint(tpath, params_template=params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, loaded["params"], params)
    with torch.no_grad():
        _close(fresh(batch), jmodel.apply(loaded["params"], jbatch))


# ---- PDBBind data --------------------------------------------------------------------

def _raw(root, n=4, ligand="lig.sdf"):
    raw = root / "raw"
    raw.mkdir(parents=True)
    shutil.copyfile("examples/1h36_A_rec_1h36_r88_lig_tt_docked_0_pocket10.pdb",
                    raw / "pocket.pdb")
    shutil.copyfile("examples/3ug2_ligand.sdf", raw / "ligand.sdf")
    (raw / "lig.sdf").write_text("NOT AN SDF\n")
    (raw / "lig.mol2").write_text(BENZENE_MOL2)
    index = [{"pocket": "pocket.pdb", "ligand": "ligand.sdf", "pk": 5.0 + i, "kind": i % 3 + 1}
             for i in range(n)]
    index[1] = {"pocket": "pocket.pdb", "ligand": ligand, "pk": 7.5, "kind": 2}
    with open(raw / "index.pkl", "wb") as f:
        pickle.dump(index, f)
    return raw


def _emb_export(n_prot=572, n_lig=31, hidden=8):
    rng = np.random.default_rng(3)
    pv = rng.dirichlet(np.ones(13), n_lig).astype(np.float32)
    return [{"ligand_filename": "ligand.sdf", "kl_pos": rng.random(5), "kl_v": rng.random(5),
             "pred_ligand_v": pv, "final_h": rng.normal(size=(n_prot + n_lig, hidden))}]


@pytest.mark.parametrize("emb_format", [None, "pickle", "torch"])
def test_pdbbind_dataset_matches_jax(emb_format, tmp_path):
    """Processing with the mol2 retry (entry 1's SDF fails, its MOL2 parses)
    and the merge of a likelihood export by ligand file name."""
    emb_path = None
    if emb_format:
        emb_path = str(tmp_path / "emb.bin")
        if emb_format == "pickle":
            with open(emb_path, "wb") as f:
                pickle.dump(_emb_export(), f)
        else:
            torch.save(_emb_export(), emb_path)
    ours = datasets.PDBBindDataset(str(_raw(tmp_path / "port") / "index.pkl"), emb_path=emb_path)
    ref = jdatasets.PDBBindDataset(str(_raw(tmp_path / "jax") / "index.pkl"), emb_path=emb_path)
    assert len(ours) == len(ref) == 4
    for i in range(4):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    assert ours[1]["ligand_element"].tolist() == [6] * 6
    assert ("final_h" in ours[0]) == bool(emb_format) and "final_h" not in ours[1]


def test_pdbbind_processing_fails_loudly_on_mass_skips(tmp_path):
    raw = _raw(tmp_path, ligand="missing.sdf")
    with open(raw / "index.pkl", "wb") as f:
        pickle.dump([{"pocket": "pocket.pdb", "ligand": "missing.sdf", "pk": 5.0, "kind": 1}] * 4,
                    f)
    with pytest.raises(RuntimeError, match="silently-shrunken"):
        datasets.PDBBindDataset(str(raw / "index.pkl"))
    assert not RecordStore.exists(str(raw / "pdbbind_processed_final"))
