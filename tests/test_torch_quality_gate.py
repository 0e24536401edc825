"""The port's quality gate (targetdiff_tpu_torch/tools/quality_gate.py)
against the JAX package's tools/quality_gate.py on the CPU: the same limits
and checks, the same corpus profile and self-score, the broken-aromatics
cases trip it, and a tiny end-to-end run (a 2-layer, hidden-32 model)
returns a complete report."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from targetdiff_tpu_torch.tools import quality_gate as qg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import quality_gate as jqg  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(num_layers=2, hidden_dim=32, n_heads=4)


def _close(got, want, where="value"):
    """Equal structures: floats within 1e-12, everything else exactly."""
    if isinstance(want, dict):
        assert sorted(got, key=repr) == sorted(want, key=repr), where
        for k in want:
            _close(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape, where
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=where)
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-12, (where, got, want)
    else:
        assert got == want, (where, got, want)


def test_gates_and_model_are_the_jax_gates():
    assert qg.GATES == jqg.GATES
    assert (qg.NP_, qg.NL, qg.BATCH, qg.ATOM_MODE) == (jqg.NP_, jqg.NL, jqg.BATCH, jqg.ATOM_MODE)


def _evaluations():
    """Evaluation dicts around the recorded TPU v5e run's: each as it is,
    each field moved across its limit, and the None cases."""
    import json
    from pathlib import Path

    rec = json.loads((Path(__file__).resolve().parents[1] / "quality_gate.json").read_text())
    base = [rec["corpus"], rec["untrained"], rec["trained"]]
    out = list(base)
    for ev in base:
        for key, delta in (("mol_stable", -0.1), ("atom_stable", -0.2), ("recon_success", -0.2),
                           ("pair_jsd_vs_train", 0.1), ("atom_type_jsd_vs_train", 0.1),
                           ("bond_jsd_vs_train", 0.2), ("n_aromatic_predicted", -200),
                           ("ring_recovery", -0.6), ("n_classes", -6)):
            out.append(dict(ev, **{key: ev[key] + delta}))
        for key in ("pair_jsd_vs_train", "atom_type_jsd_vs_train", "bond_jsd_vs_train",
                    "ring_recovery"):
            out.append(dict(ev, **{key: None}))
    return out


def test_gate_checks_are_the_jax_checks():
    evs = _evaluations()
    outcomes = set()
    for ev_u in evs:
        for ev_t in evs:
            got = qg.gate_checks(ev_u, ev_t)
            assert got == jqg.gate_checks(ev_u, ev_t)
            outcomes.add(tuple(got.values()))
    assert len(outcomes) > 20  # both outcomes of every check are exercised


def test_corpus_profile_and_self_score_match_the_jax_gate():
    pool, jpool = qg.make_pool(seed=2, pool=24), jqg.make_pool(seed=2, pool=24)
    prof, jprof = qg.train_profile(pool, n=24), jqg.train_profile(jpool, n=24)
    _close(prof, jprof, "profile")
    assert 4 in {bt[2] for bt in prof["bond"]}
    ev = qg.evaluate(qg.corpus_mols(pool, 24), prof)
    _close(ev, jqg.evaluate(jqg.corpus_mols(jpool, 24), jprof), "self-score")
    assert ev["recon_success"] == 1.0 and ev["ring_recovery"] >= 0.9


def test_broken_aromatics_trip_the_port_gate():
    """tests/test_quality_tools.py's broken-aromatics case through the
    port's gate: (a) aromatic classes mapped to their non-aromatic twins,
    (b) ring atoms jittered by 1.5 A."""
    pool = qg.make_pool(seed=2, pool=24)
    prof = qg.train_profile(pool, n=24)
    mols = qg.corpus_mols(pool, 24)
    clean = qg.evaluate(mols, prof)
    checks = qg.gate_checks(clean, clean)
    assert checks["ring_recovery"] and checks["aromatics_emitted"] and checks["class_coverage"]

    demote = {2: 1, 4: 3, 6: 5, 9: 8, 11: 10}
    broken_v = [{"pos": m["pos"], "v": np.array([demote.get(int(x), int(x)) for x in m["v"]])}
                for m in mols]
    ev_a = qg.evaluate(broken_v, prof)
    assert not qg.gate_checks(ev_a, ev_a)["aromatics_emitted"]

    rng = np.random.default_rng(0)
    broken_g = [{"pos": m["pos"] + rng.normal(0, 1.5, m["pos"].shape), "v": m["v"]}
                for m in mols]
    ev_b = qg.evaluate(broken_g, prof)
    assert not qg.gate_checks(ev_b, ev_b)["ring_recovery"]


def test_train_copies_the_untrained_weights():
    model = qg.build_model("cpu", **SMALL)
    pool = qg.make_pool(seed=2, pool=40)
    untrained, trained, loss_hist = qg.train(model, pool, 3, log=lambda _: None)
    assert len(loss_hist) == 2 and all(math.isfinite(x) for x in loss_hist)
    assert untrained.keys() == trained.keys()
    moved = [k for k in trained if not torch.equal(untrained[k], trained[k])]
    assert len(moved) > len(trained) // 2
    assert all(torch.equal(trained[k], v) for k, v in model.net.state_dict().items())


def test_tiny_gate_run_returns_a_complete_report():
    report = qg.run_gate(3, 4, device="cpu", num_steps=10, n_pockets=2, pool_size=24,
                         corpus_n=24, log=lambda _: None, **SMALL)
    for name in ("corpus", "untrained", "trained"):
        ev = report[name]
        assert set(ev) == set(report["corpus"]) and ev["n"] == (24 if name == "corpus" else 4)
        assert 0.0 <= ev["mol_stable"] <= 1.0 and 0.0 <= ev["recon_success"] <= 1.0
    assert set(report["checks"]) == set(jqg.gate_checks(report["untrained"], report["trained"]))
    assert all(isinstance(ok, bool) for ok in report["checks"].values())
    assert len(report["loss_hist"]) == 2 and all(math.isfinite(x) for x in report["loss_hist"])
    assert report["train_steps"] == 3 and report["chunks"] == 1
    assert all(math.isfinite(t) and t >= 0 for t in report["timing"].values())


def test_gate_cli_runs_on_the_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        qg.main(["1", "4", str(tmp_path / "out.json")])
    assert not (tmp_path / "out.json").exists()


def _jax_ddim_rows():
    """The `configs` list of tools/ddim_eval.py's main, evaluated."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1] / "tools" / "ddim_eval.py").read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "configs")
    return eval(compile(ast.Expression(node.value), "ddim_eval", "eval"), {"dict": dict})


def test_ddim_eval_rows_are_the_jax_rows():
    from targetdiff_tpu_torch.tools import ddim_eval

    assert ddim_eval.ROWS == _jax_ddim_rows()


def test_ddim_eval_counts_network_evaluations():
    from targetdiff_tpu_torch.tools.ddim_eval import nfe

    assert nfe(1000, 1000) == 1000 and nfe(1000, 100) == 100
    assert nfe(1000, 100, "ddim") == 100 and nfe(1000, 50, "dpm2") == 99
    # quadratic spacing rounds several low-t grid points onto one timestep
    assert nfe(1000, 100, "ddim", "quadratic") < 100
    assert nfe(1000, 50, "dpm2", "quadratic") == 2 * nfe(1000, 50, "ddim", "quadratic") - 1


def test_ddim_eval_checks():
    from targetdiff_tpu_torch.tools.ddim_eval import ROWS, checks

    base = {name: {"atom_stable": 0.85} for name, _ in ROWS}
    ok = dict(base, **{"ddpm-1000": {"atom_stable": 0.89},
                       "ddpm-100-trunc": {"atom_stable": 0.23}})
    assert checks(ok) == {"rows_complete": True, "ddim_keeps_atom_stability": True,
                          "truncation_collapses": True}
    lost = dict(ok, **{"ddim-100": {"atom_stable": 0.78}})
    assert not checks(lost)["ddim_keeps_atom_stability"]
    assert not checks(dict(ok, **{"ddpm-100-trunc": {"atom_stable": 0.6}}))["truncation_collapses"]
    assert checks({k: v for k, v in ok.items() if k != "dpm2-25"}) == {"rows_complete": False}


def test_tiny_ddim_eval_run_reports_every_row():
    from targetdiff_tpu_torch.tools import ddim_eval

    rows = [("ddpm-20", dict(num_steps=20, sampler="ddpm")),
            ("ddpm-2-trunc", dict(num_steps=2, sampler="ddpm")),
            ("ddim-4-quad-eta1", dict(num_steps=4, sampler="ddim", eta=1.0,
                                      ddim_spacing="quadratic")),
            ("dpm2-3", dict(num_steps=3, sampler="dpm2", eta=0.0))]
    report = ddim_eval.run(2, 4, device="cpu", rows=rows, n_pockets=2, pool_size=24,
                           corpus_n=24, log=lambda _: None, num_diffusion_timesteps=20, **SMALL)
    assert report["train"]["steps"] == 2 and len(report["train"]["loss_hist"]) == 2
    assert [report[name]["nfe"] for name, _ in rows] == [20, 2, 4, 5]
    for name, _ in rows:
        ev = report[name]
        assert ev["n"] == 4 and ev["chunks"] == 1 and 0.0 <= ev["atom_stable"] <= 1.0
        assert all(math.isfinite(ev[k]) and ev[k] > 0
                   for k in ("sample_seconds", "mols_per_sec", "ms_per_nfe"))
