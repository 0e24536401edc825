"""The port's PDBBind preparation, affinity CLIs and prop gate against the
JAX package on the CPU: `pdbbind_preparation` (byte-equal outputs), the
train -> eval -> inference CLIs with checkpoints read across the packages
(inference within 1e-4 of the JAX model's pK), PropPredNetEnc trained from
a likelihood export, and a tiny run of the prop gate, whose limits and
set-up are the JAX script's."""

import glob
import inspect
import os
import pickle
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from targetdiff_tpu.data import transforms_prop as jtp
from targetdiff_tpu.models.prop import prop_model as jpm
from targetdiff_tpu.utils import checkpoint as jckpt
from targetdiff_tpu.utils import misc_prop as jmisc
from targetdiff_tpu_torch.config import Config
from targetdiff_tpu_torch.data import datasets
from targetdiff_tpu_torch.models.prop import prop_model as pm
from targetdiff_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_prop import REL, _emb_export, prop_config

torch.set_num_threads(2)


def _pdbbind_root(root, ids=("3ug2",)):
    """A PDBBind-style tree from the 3ug2 example and its INDEX file."""
    src = root / "pdbbind"
    for pid in ids:
        (src / pid).mkdir(parents=True)
        shutil.copyfile("examples/3ug2_protein.pdb", src / pid / f"{pid}_protein.pdb")
        shutil.copyfile("examples/3ug2_ligand.sdf", src / pid / f"{pid}_ligand.sdf")
    index = root / "INDEX_general_PL_data.2016"
    lines = ["# PDB code, resolution, release year, -logKd/Ki, Kd/Ki, reference, ligand name"]
    for i, pid in enumerate(ids):
        kind = ("Kd=3.2nM", "Ki=10uM", "IC50~4mM")[i % 3]
        lines.append(f"{pid}  2.10  2012   {8.49 - i:.2f}  {kind}  // 3ug2.pdf (0DS)")
    lines.append("bad1  2.10  2012   5.00  Kd=1nM  // missing files")
    index.write_text("\n".join(lines) + "\n")
    return src, index


class _SerialPool:
    """multiprocessing.Pool's map in this process (no fork beside JAX's threads)."""

    def __init__(self, n):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, items):
        return [fn(x) for x in items]


def test_pdbbind_preparation_matches_jax(tmp_path, monkeypatch):
    from targetdiff_tpu.cli import pdbbind_preparation as jprep
    from targetdiff_tpu_torch.cli import pdbbind_preparation as prep

    monkeypatch.setattr(jprep, "Pool", _SerialPool)

    src, index = _pdbbind_root(tmp_path, ("3ug2", "1abc", "2xyz"))
    outs = {}
    for name, mod in (("port", prep), ("jax", jprep)):
        dest = tmp_path / name
        mod.main(["pockets", "--root", str(src), "--index", str(index), "--dest", str(dest),
                  "--num_workers", "1"])
        for extra in ([], ["--coreset_ids", str(tmp_path / "core.txt")]):
            (tmp_path / "core.txt").write_text("1abc\n")
            mod.main(["split", "--index_pkl", str(dest / "index.pkl"), "--dest",
                      str(dest / f"split{len(extra)}.pt"), "--test_frac", "0.34", *extra])
        outs[name] = dest
    files = sorted(p.relative_to(outs["jax"]).as_posix() for p in outs["jax"].rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(outs["port"]).as_posix()
                           for p in outs["port"].rglob("*") if p.is_file())
    assert "3ug2/3ug2_pocket10.pdb" in files
    for f in files:
        if f.endswith(".pt"):
            assert torch.load(outs["port"] / f) == torch.load(outs["jax"] / f), f
        else:
            assert (outs["port"] / f).read_bytes() == (outs["jax"] / f).read_bytes(), f
    with open(outs["port"] / "index.pkl", "rb") as fh:
        index = pickle.load(fh)
    assert [e["kind"] for e in index] == [2, 1, 3] and index[0]["pk"] == 8.49


# ---- the prop CLIs ------------------------------------------------------------------

def _cli_tree(tmp_path, n=6):
    """pdbbind_preparation's outputs for n copies of the 3ug2 entry, and a
    split of 4 / 2."""
    from targetdiff_tpu_torch.cli import pdbbind_preparation as prep

    ids = [f"{i}ug2" for i in range(n)]
    src, index = _pdbbind_root(tmp_path, ids)
    dest = tmp_path / "prepared"
    prep.main(["pockets", "--root", str(src), "--index", str(index), "--dest", str(dest),
               "--num_workers", "1"])
    split = str(tmp_path / "split.pt")
    torch.save({"train": list(range(n - 2)), "test": [n - 2, n - 1]}, split)
    return str(dest / "index.pkl"), split


def _prop_cfg(index, split):
    return {"data": {"name": "pdbbind", "path": index, "split": split},
            "model": prop_config(knn=8, hidden=16, layers=1, rbf=8),
            "train": {"seed": 2021, "batch_size": 2, "max_epochs": 2, "pos_noise_std": 0.1,
                      "max_grad_norm": 8.0,
                      "optimizer": {"type": "adam", "lr": 1.0e-3, "weight_decay": 0,
                                    "beta1": 0.95, "beta2": 0.999},
                      "scheduler": {"type": "plateau", "factor": 0.6, "patience": 10,
                                    "min_lr": 1.0e-6}}}


PAD = ["--max_protein", "768", "--max_ligand", "40"]


def test_train_eval_inference_prop_clis(tmp_path):
    import yaml

    from targetdiff_tpu.cli import eval_prop as jeval
    from targetdiff_tpu.cli import inference_prop as jinfer
    from targetdiff_tpu_torch.cli import eval_prop, inference_prop, train_prop

    index, split = _cli_tree(tmp_path)
    cfg_path = str(tmp_path / "prop.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_prop_cfg(index, split), f)
    out = train_prop.main([cfg_path, "--logdir", str(tmp_path / "logs"), "--device", "cpu", *PAD])
    assert out["checkpoints"] and out["iterations"] == 4
    assert np.isfinite(list(out["scores"].values())).all()
    log = open(os.path.join(out["log_dir"], "log.txt")).read()
    assert "[val] epoch 1" in log
    ck = out["checkpoints"][-1]
    res = eval_prop.main([ck, "--device", "cpu", "--batch_size", "2", *PAD])
    assert res["n"] == 2 and np.isfinite(res["overall"]["rmse"])
    jeval.main([ck, "--batch_size", "2", *PAD])  # the JAX CLI reads the port's checkpoint
    # the JAX CLI's predictions from the port's checkpoint equal the port's
    model = train_prop.build_model(Config(_prop_cfg(index, split)["model"]), "cpu")
    model.load_state_dict(ckpt.load_checkpoint(ck)["state_dict"])
    pk = inference_prop.main([ck, "--protein", "examples/3ug2_protein.pdb", "--ligand",
                              "examples/3ug2_ligand.sdf", "--device", "cpu"])
    jmodel = jpm.PropPredNet(config=dict(yaml.safe_load(open(cfg_path))["model"]), output_dim=3)
    data = jinfer.build_complex("examples/3ug2_protein.pdb", "examples/3ug2_ligand.sdf")
    from targetdiff_tpu.data.transforms import FeaturizeProteinAtom as JFPA

    data = jtp.FeaturizeLigandAtomProp()(JFPA()(data))
    data["kind"] = 2
    jbatch = jmisc.collate_prop([data], 768, 128)
    params = jckpt.load_checkpoint(ck, params_template=jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jbatch))["params"]
    assert pk == pytest.approx(float(jax.jit(jmodel.apply)(params, jbatch)[0]), rel=REL, abs=REL)
    # and the port's eval reads the JAX CLI's checkpoint
    from targetdiff_tpu.cli import train_prop as jtrain

    jcfg = _prop_cfg(index, split)
    jcfg["train"]["max_epochs"] = 1
    with open(cfg_path, "w") as f:
        yaml.safe_dump(jcfg, f)
    jtrain.main([cfg_path, "--logdir", str(tmp_path / "jlogs"), *PAD])
    jck = sorted(glob.glob(str(tmp_path / "jlogs" / "*" / "prop_ckpt_*.npz")))[-1]
    res = eval_prop.main([jck, "--device", "cpu", "--batch_size", "2", *PAD])
    assert res["n"] == 2 and np.isfinite(res["overall"]["rmse"])


def test_train_prop_enc_reads_an_embedding_export(tmp_path):
    """PropPredNetEnc on final_h merged from a likelihood export; complexes
    absent from it are skipped."""
    from targetdiff_tpu_torch.cli import eval_prop, train_prop

    index, split = _cli_tree(tmp_path)
    with open(index, "rb") as f:
        entries = pickle.load(f)
    n_prot = len(datasets.PDBBindDataset(index)[0]["protein_pos"])
    export = []
    for e in entries[1:]:  # entry 0 has no features: skipped
        rec = _emb_export(n_prot=n_prot, hidden=8)[0]
        rec["ligand_filename"] = e["ligand"]
        export.append(rec)
    emb = str(tmp_path / "emb.pkl")
    with open(emb, "wb") as f:
        pickle.dump(export, f)
    cfg = _prop_cfg(index, split)
    cfg["data"]["emb_path"] = emb
    cfg["model"].update(enc_ligand_dim=0, enc_node_dim=8, enc_graph_dim=0,
                        enc_feature_type="final_h")
    cfg["model"]["encoder"]["name"] = "egnn_enc"
    args = train_prop.parser().parse_args(["unused.yml", "--logdir", str(tmp_path / "logs"),
                                           "--device", "cpu", *PAD])
    out = train_prop.run(Config(cfg), args)
    assert out["iterations"] == 2  # 3 of the 4 train complexes have features: one batch
    assert isinstance(out["model"], pm.PropPredNetEnc)
    res = eval_prop.main([out["checkpoints"][-1], "--device", "cpu", "--batch_size", "2", *PAD])
    assert res["n"] == 2


def test_prop_clis_refuse_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from targetdiff_tpu_torch.cli import train_prop

    args = train_prop.parser().parse_args(["unused.yml", "--logdir", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        train_prop.run(Config({}), args)


# ---- the prop gate -----------------------------------------------------------------

def _jax_gate_limits():
    """The limits written in tools/prop_quality_gate.py's checks."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_prop_gate", "tools/prop_quality_gate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = inspect.getsource(mod.main)
    num = r"([0-9.]+)"
    pats = dict(pearson_min=rf'ev_t\["pearson"\] >= {num}',
                rmse_over_std_max=rf'ev_t\["rmse"\] <= {num} \* std',
                trained_over_untrained_max=rf'ev_t\["rmse"\] <= {num} \* ev_u\["rmse"\]',
                per_kind_pearson_min=rf'v\["pearson"\] >= {num}',
                enc_pearson_min=rf'ev_enc\["pearson"\] >= {num}',
                nll_auroc_min=rf"auroc >= {num}")
    return mod, {k: float(re.search(p, src).group(1)) for k, p in pats.items()}


def test_prop_gate_limits_and_setup_are_the_jax_scripts():
    from targetdiff_tpu_torch.tools import prop_quality_gate as gate

    mod, limits = _jax_gate_limits()
    assert gate.PROP_GATES == limits
    for name in ("NP_", "NL", "POOL", "TEST", "BATCH", "NOISE"):
        assert getattr(gate, name) == getattr(mod, name), name
    # the same labels and kinds from the same seed
    b, y, contacts = gate.make_dataset(n=40)
    jb = mod.make_dataset.__globals__  # the JAX set-up, at the port's size
    import targetdiff_tpu.data.synth as jsynth

    ref = jsynth.synth_batch(np.random.default_rng(0), 40, max_protein=gate.NP_,
                             max_ligand=gate.NL)
    np.testing.assert_array_equal(b.ligand_pos.numpy(), np.asarray(ref.ligand_pos))
    assert jb["NOISE"] == gate.NOISE and np.isfinite(y).all() and contacts.shape == (40,)
    # the checks of the JAX gate's own report
    with open("prop_quality_gate.json") as f:
        report = __import__("json").load(f)
    assert gate.prop_gate_checks(report) == report["checks"]


def test_tiny_prop_gate_run():
    from targetdiff_tpu_torch.tools import prop_quality_gate as gate

    report = gate.run_prop_gate(epochs=1, diff_steps=2, device="cpu", n=48, batch=4, log=print,
                                num_layers=1, hidden_dim=16, n_heads=2, knn=8)
    for k in ("untrained", "trained", "enc_untrained", "enc_trained"):
        assert np.isfinite(list(report[k].values())).all(), k
    assert set(report["checks"]) == {"pearson", "beats_mean_predictor", "learned",
                                     "per_kind_heads", "enc_pipeline_learns",
                                     "nll_ranks_pose_quality"}
    assert 0.0 <= report["nll_distortion_auroc"] <= 1.0
    assert np.isfinite(report["nll_intact_mean"]) and report["diffusion_steps"] == 2


def test_chip_smoke_prop_configs_are_the_repos():
    """chip_smoke.py builds the PDBBind configs in code (the card's machine
    has no PyYAML): they must equal configs/prop/*.yml."""
    import yaml

    import chip_smoke

    with open("configs/prop/pdbbind_general_egnn.yml") as f:
        plain = yaml.safe_load(f)
    with open("configs/prop/pdbbind_general_egnn_enc_final_h.yml") as f:
        enc = yaml.safe_load(f)
    assert chip_smoke.PROP_MODEL == plain["model"]
    assert chip_smoke.PROP_TRAIN == plain["train"]
    assert chip_smoke.PROP_ENC_MODEL == enc["model"]
    assert chip_smoke.EGNN == dict(chip_smoke.FLAGSHIP, model_type="egnn")
