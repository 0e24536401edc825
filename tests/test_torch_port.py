"""Port plumbing: the weight bridge, the checkpoint reader, the jax-free
import chain, the kernel wrappers' refusal to fall back without CUDA or
nvcc, and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from targetdiff_tpu.utils.checkpoint import save_checkpoint
from targetdiff_tpu.utils.port import torch_state_dict_to_flax
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
from targetdiff_tpu_torch.ops.kernels import build
from targetdiff_tpu_torch.ops.kernels import knn as kknn
from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict, load_npz_params
from tests.test_port import synthetic_state_dict
from tests.test_torch_score_model import small_setup

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def test_bridge_round_trip_is_identity():
    sd = synthetic_state_dict()
    back = flax_params_to_state_dict(torch_state_dict_to_flax(sd, num_layers=2))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k


def test_npz_checkpoint_loads_into_port(tmp_path):
    cfg, _, params, _, model, _ = small_setup()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, cfg, jax.device_get(params))
    sd = flax_params_to_state_dict(load_npz_params(path))
    model.net.load_state_dict(sd)  # strict: every name and shape matches
    np.testing.assert_array_equal(
        model.net.refine_net.base_block[1].h2x_layers[0].xv_func.net[3].weight.detach().numpy(),
        np.asarray(params["params"]["refine_net"]["block_1"]["h2x_0"]["xv_func"]["lin_1"]["kernel"]).T)


def test_port_imports_without_jax_flax_optax_yaml():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, targetdiff_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(targetdiff_tpu_torch.__path__,\n"
        "                                               'targetdiff_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _cpu_inputs():
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.normal(size=(1, 12, 3)).astype(np.float32))
    return pos, torch.ones((1, 12), dtype=torch.bool)


def test_kernel_wrappers_refuse_cpu_tensors():
    pos, mask = _cpu_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        kknn.knn_graph_cuda(pos, mask, 4)
    _, _, _, _, model, _ = small_setup()
    nbh = G.knn_graph(pos, mask, 4)
    h = torch.zeros((1, 12, 32))
    with pytest.raises(ValueError, match="CUDA"):
        kblock.block_denoiser_cuda(model.net.refine_net, h, pos, nbh, mask, 4)
    assert kknn.LAUNCHES == 0 and kblock.LAUNCHES == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "NVCC_CANDIDATES", [])
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "_build")
    build.load_library.cache_clear()
    try:
        with pytest.raises(build.KernelBuildError, match="nvcc not found"):
            build.load_library()
    finally:
        build.load_library.cache_clear()
    assert not (tmp_path / "_build").exists() or not any((tmp_path / "_build").rglob("*.so"))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    if where == "repo":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: chip_smoke.py runs for real here")
        cwd, script = REPO, REPO / "chip_smoke.py"
    else:
        cwd = tmp_path
        script = Path(shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_pad_complex_and_replicate_match_jax():
    from targetdiff_tpu.data import batch as jbatch
    from targetdiff_tpu_torch.data import batch as tbatch

    rng = np.random.default_rng(0)
    args = (rng.normal(size=(5, 3)).astype(np.float32), rng.random((5, 27)).astype(np.float32),
            rng.normal(size=(3, 3)).astype(np.float32), np.array([1, 4, 2]), 8, 4)
    ref = jbatch.replicate(jbatch.pad_complex(*args), 3)
    out = tbatch.replicate(tbatch.pad_complex(*args), 3)
    assert out.num_graphs == 3
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
