"""The port's readers of sampling output against their JAX originals on the
CPU: `utils/visualize` (trajectory frames from a trajectory the port's
sampler saved, file for file and byte for byte; the text-block fallbacks,
py3Dmol being absent), `cli/summarize_results` on a metrics.pkl written by
the port's evaluation CLI (the same table and printout, with and without
Vina fields), and `cli/evaluate_from_meta` with `--docking_mode none` (the
same per-pocket summaries and averages, floats within 1e-12)."""

import contextlib
import io
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from targetdiff_tpu.chem import reconstruct as jax_reconstruct
from targetdiff_tpu.cli import evaluate_from_meta as jax_meta
from targetdiff_tpu.cli import summarize_results as jax_summarize
from targetdiff_tpu.utils import visualize as jax_visualize
from targetdiff_tpu_torch.chem import reconstruct
from targetdiff_tpu_torch.cli import evaluate_diffusion, evaluate_from_meta, summarize_results
from targetdiff_tpu_torch.cli.sample_diffusion import write_result
from targetdiff_tpu_torch.utils import visualize
from tests.test_torch_evaluation import MODE, _close, _mols, _rebuild
from tests.test_torch_score_model import small_setup

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _trajectory():
    """Two molecules' trajectories (every step) from the port's dpm2 sampler."""
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand

    _, _, _, _, model, _ = small_setup()
    rng = np.random.default_rng(5)
    pocket = {"protein_pos": rng.normal(size=(14, 3)).astype(np.float32) * 3 + 10.0,
              "protein_feat": (rng.random((14, 27)) > 0.7).astype(np.float32)}
    out = sample_diffusion_ligand(model, pocket, num_samples=2,
                                  generator=torch.Generator().manual_seed(1), num_steps=6,
                                  max_protein=16, max_ligand=8, return_traj=True,
                                  sampler="dpm2", eta=1.0)
    return list(zip(out["pos_traj"], out["v_traj"]))


@pytest.mark.parametrize("stride", [1, 2, 50])
def test_visualize_trajectory_writes_the_jax_frames(stride, tmp_path):
    for i, (pos_traj, v_traj) in enumerate(_trajectory()):
        got = visualize.visualize_trajectory(pos_traj, v_traj, MODE, str(tmp_path / f"p{i}"),
                                             stride=stride)
        want = jax_visualize.visualize_trajectory(pos_traj, v_traj, MODE,
                                                  str(tmp_path / f"j{i}"), stride=stride)
        assert [Path(p).name for p in got] == [Path(p).name for p in want]
        assert len(got) == -(-len(pos_traj) // stride)
        for g, w in zip(got, want):
            assert Path(g).read_bytes() == Path(w).read_bytes()
        first = Path(got[0]).read_text().splitlines()
        assert first[:2] == [str(len(v_traj[0])), "step 0"] and len(first) == 2 + len(v_traj[0])


def test_viewers_fall_back_to_the_jax_text_blocks():
    pos, v = _mols(0.0)[64]  # an example ligand
    mol, jmol = _rebuild(reconstruct, pos, v), _rebuild(jax_reconstruct, pos, v)
    assert visualize.visualize_generated_mol(mol) == jax_visualize.visualize_generated_mol(jmol)
    pdb = (REPO / "examples" / "1h36_A_rec_1h36_r88_lig_tt_docked_0_pocket10.pdb").read_text()
    blocks = visualize.visualize_generated_mol(mol)["sdf"]
    assert (visualize.visualize_complex(pdb, blocks)
            == jax_visualize.visualize_complex(pdb, blocks) == {"pdb": pdb, "sdf": blocks})


def _metrics(tmp_path) -> Path:
    """metrics.pkl of the port's evaluation CLI over 40 jittered molecules."""
    mols = _mols(0.3)[:30] + _mols(0.0)[60:]
    write_result(tmp_path / "result_0.pkl", [m[0] for m in mols], [m[1] for m in mols], MODE)
    evaluate_diffusion.main([str(tmp_path)])
    return tmp_path / "metrics.pkl"


def _printout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_summarize_results_prints_the_jax_table(tmp_path):
    path = _metrics(tmp_path)
    table = summarize_results.summarize(str(path))
    assert table == jax_summarize.summarize(str(path))
    assert table["N results"] > 0 and table["QED (mean/med)"] != "-"
    assert not any(k.startswith("Vina") for k in table)
    assert (_printout(summarize_results.main, [str(path)])
            == _printout(jax_summarize.main, [str(path)]))

    # Vina fields (as JAX's docking modes write them) and a reference set
    data = pickle.loads(path.read_bytes())
    rng = np.random.default_rng(0)
    for r in data["results"]:
        r["vina"] = {"score": float(rng.normal(-6, 1)), "dock": float(rng.normal(-7, 1))}
    vina_path = tmp_path / "metrics_vina.pkl"
    vina_path.write_bytes(pickle.dumps(data))
    ref_path = tmp_path / "testset_vina.pkl"
    ref_path.write_bytes(pickle.dumps([{"vina": [{"affinity": a}]} for a in (-7.5, -6.0, -8.1)]
                                      + [{"vina": None}]))
    argv = [str(path), str(vina_path), "--ref_vina_pkl", str(ref_path)]
    out = _printout(summarize_results.main, argv)
    assert out == _printout(jax_summarize.main, argv)
    assert "High-affinity % (dock)" in out and "Vina score (mean/med)" in out


def _meta(tmp_path, suffix):
    """Two pockets' samples in the reference's meta layout."""
    mols = _mols(0.7)
    meta = [{"pred_ligand_pos": [m[0] for m in mols[i:i + 12]],
             "pred_ligand_v": [m[1] for m in mols[i:i + 12]]} for i in (0, 54)]
    path = tmp_path / f"meta{suffix}"
    if suffix == ".pt":
        torch.save(meta, path)
    else:
        path.write_bytes(pickle.dumps(meta))
    return path


@pytest.mark.parametrize("suffix,workers", [(".pkl", 1), (".pt", 2)])
def test_evaluate_from_meta_matches_the_jax_cli(suffix, workers, tmp_path):
    path = _meta(tmp_path, suffix)
    evaluate_from_meta.main([str(path), "--num_workers", str(workers),
                             "--out", str(tmp_path / "port.pkl")])
    jax_meta.main([str(path), "--num_workers", "1", "--docking_mode", "none",
                   "--out", str(tmp_path / "jax.pkl")])
    got, want = (pickle.loads((tmp_path / f).read_bytes()) for f in ("port.pkl", "jax.pkl"))
    assert len(got["per_pocket"]) == 2
    _close(got, want, "meta metrics")
    assert 0 < got["aggregate"]["recon_success"] <= 1
    evaluate_from_meta.main([str(path), "--num_workers", "1", "--eval_num_examples", "1"])
    assert len(pickle.loads(Path(str(path) + ".metrics.pkl").read_bytes())["per_pocket"]) == 1


def test_evaluate_from_meta_refuses_docking(tmp_path):
    with pytest.raises(SystemExit):
        evaluate_from_meta.main([str(tmp_path / "meta.pkl"), "--docking_mode", "qvina"])
