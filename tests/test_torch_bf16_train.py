"""The port's bf16 training, the JAX package's bf16 training variant
(`get_diffusion_loss(impl='fast_bf16' | 'fast_bf16_pl')`), on the CPU: the
plain versions of the bf16 train-mode and backward kernels (the eager block
under autograd with every attention product a `precision.Bf16Linear`)
against the JAX package's bf16 Pallas kernels in interpret mode and its
float32 XLA loss, with the same draws (the JAX key's) and bridged weights.

The bar is the JAX package's own bf16 training bar
(tests/test_fast_train.py:test_fast_bf16_train_grads_close_to_xla): the
loss within 2e-2 relative, every gradient leaf within 0.08 of max(max|g|,
1e-2). That bar alone would pass a float32 step, so the rounding is shown
apart: the bf16 gradients differ from the port's float32 ones, a recording
of the products shows every dense product of the attention layers ran on
bf16 operands in both directions while the edge-weight MLP's did not, and
every gradient is float32 (not rounded to bf16 after its product). The
backward kernel's replay (tests/test_torch_block_vjp.py replay_block_bwd)
in its bf16 mode is held to autograd of the plain bf16 block at the JAX
package's bf16 kernel bar (tools/kparity.py:91, 2e-2 of each tensor's
scale). Then `train_diffusion --dtype bf16` on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from targetdiff_tpu_torch.cli import train_diffusion
from targetdiff_tpu_torch.ops import precision
from targetdiff_tpu_torch.ops.precision import round_bf16
from targetdiff_tpu_torch.utils.checkpoint import load_checkpoint
from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict
from tests.test_torch_block_vjp import SPLIT_CASES, _replay_and_autograd, _split_setup, jax_draws
from tests.test_torch_data import _data_cfg, _mini_raw
from tests.test_fast_forward import small_flagship
from tests.test_torch_egnn import egnn_config
from tests.test_torch_score_model import small_setup

torch.set_num_threads(2)

LOSS_BAR = 2e-2  # JAX's bf16 training bar: loss, relative
GRAD_BAR = 0.08  # and each leaf, of max(max |g|, GRAD_FLOOR)
GRAD_FLOOR = 1e-2
KERNEL_BAR = 2e-2  # JAX's bf16 kernel bar (tools/kparity.py:91)
IMPLS = ("fast_bf16", "fast_bf16_pl")
JAX_IMPLS = IMPLS + ("xla",)


def _bf16_exact(t) -> bool:
    return bool(torch.equal(t, round_bf16(t)))


@pytest.fixture(scope="module")
def runs():
    """The JAX losses and gradients (both bf16 impls in interpret mode, the
    float32 XLA loss) and the port's (both bf16 impls and float32 'fast'),
    from one setup and the JAX key's draws; the port's bf16 runs record
    their products (precision._product) and the edge-weight MLP's Linear
    inputs and output gradients."""
    _, jmodel, params, jbatch, model, batch = small_setup()
    key, t = jax.random.PRNGKey(5), np.array([2, 7])
    jax_out = {}
    for impl in JAX_IMPLS:
        def loss_fn(p, impl=impl):
            return jmodel.get_diffusion_loss(p, key, jbatch, time_step=jnp.asarray(t),
                                             impl=impl)["loss"]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        jax_out[impl] = (float(loss), flax_params_to_state_dict(jax.device_get(grads)))
    eps, u = jax_draws(key, jbatch, jmodel.num_classes)
    ew_linears = [m for m in model.net.refine_net.edge_pred_layer.modules()
                  if isinstance(m, torch.nn.Linear)]
    port = {}
    for impl in IMPLS + ("fast",):
        products, ew_seen = [], []
        hooks = [m.register_forward_hook(lambda m, a, out: ew_seen.append(("in", a[0].detach())))
                 for m in ew_linears]
        hooks += [m.register_full_backward_hook(
            lambda m, gin, gout: ew_seen.append(("grad_out", gout[0].detach())))
            for m in ew_linears]
        product = precision._product

        def recording(kind, a, b, products=products, product=product):
            products.append((kind, a, b))
            return product(kind, a, b)

        precision._product = recording
        try:
            model.net.zero_grad()
            out = model.get_diffusion_loss(batch, time_step=torch.from_numpy(t), pos_noise=eps,
                                           v_uniform=u, impl=impl)
            out["loss"].backward()
        finally:
            precision._product = product
            for hk in hooks:
                hk.remove()
        port[impl] = dict(loss=float(out["loss"].detach()), products=products, ew_seen=ew_seen,
                          grads={n: p.grad.clone() for n, p in model.net.named_parameters()})
    return model, jax_out, port


@pytest.mark.parametrize("ref", ["bf16", "xla"])
@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_loss_and_grads_match_jax(runs, impl, ref):
    """Loss and every parameter gradient of the port's bf16 step against the
    JAX package's bf16 step of the same impl (interpret mode) and against
    its float32 XLA step, at the JAX package's own bf16 bar."""
    _, jax_out, port = runs
    la, want = jax_out[impl if ref == "bf16" else "xla"]
    got = port[impl]
    assert abs(got["loss"] - la) / abs(la) < LOSS_BAR
    assert sorted(got["grads"]) == sorted(want)
    worst = 0.0
    for name, a in want.items():
        a, b = a.numpy(), got["grads"][name].numpy()
        scale = max(np.abs(a).max(), GRAD_FLOOR)
        err = np.abs(a - b).max() / scale
        worst = max(worst, err)
        assert err < GRAD_BAR, f"{name}: {err:.3e} of scale"
    print(f"{impl} vs JAX {ref}: loss {abs(got['loss'] - la) / abs(la):.2e}, "
          f"worst leaf {worst:.3e} of scale")


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_grads_differ_from_float32(runs, impl):
    """The bf16 gradients are not the float32 ones: some leaf lies more than
    1e-3 of its scale from the port's float32 step (the float32 step sits
    ~1e-6 from JAX's XLA one, tests/test_torch_block_vjp.py)."""
    _, _, port = runs
    g16, g32 = port[impl]["grads"], port["fast"]["grads"]
    worst = max(float((g16[n] - g).abs().max()) / max(float(g.abs().max()), GRAD_FLOOR)
                for n, g in g32.items())
    print(f"{impl} - float32: {worst:.3e} of scale")
    assert worst > 1e-3


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_rounds_every_attention_product_both_ways(runs, impl):
    """Every Linear of the attention MLPs (k, v, q of both sub-layers, every
    layer) ran once forward, once for its input gradient and once for its
    weight gradient as a bf16 product (both operands bf16-representable);
    the float32 step ran none; the edge-weight MLP's Linears saw float32
    inputs and output gradients, not rounded ones."""
    model, _, port = runs
    rn = model.net.refine_net
    n_linear = sum(isinstance(m, torch.nn.Linear) for layer in rn.base_block
                   for sub in (layer.x2h_layers[0], layer.h2x_layers[0]) for m in sub.modules())
    assert n_linear == 2 * 3 * 2 * len(rn.base_block)
    products = port[impl]["products"]
    kinds = [k for k, _, _ in products]
    for kind in ("forward", "input_grad", "weight_grad"):
        assert kinds.count(kind) == n_linear * rn.num_blocks, kind
    assert len(kinds) == 3 * n_linear * rn.num_blocks
    assert all(_bf16_exact(a) and _bf16_exact(b) for _, a, b in products)
    assert not port["fast"]["products"]
    seen = port[impl]["ew_seen"]
    assert {k for k, _ in seen} == {"in", "grad_out"}
    assert not any(_bf16_exact(v) for _, v in seen)


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_grads_are_float32_and_not_rounded(runs, impl):
    """Every parameter gradient is float32, and no weight matrix's gradient is
    bf16-representable throughout: the products' float32 sums are kept, not
    rounded to bf16 after the product."""
    model, _, port = runs
    grads = port[impl]["grads"]
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(p.dtype == torch.float32 for p in model.net.parameters())
    matrices = [n for n, g in grads.items() if g.dim() == 2 and "refine_net.base_block" in n]
    assert matrices
    assert not [n for n in matrices if _bf16_exact(grads[n])]


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_bf16_backward_replay_matches_autograd_of_plain_bf16_block(case):
    """The bf16 backward kernel's algorithm (replay_block_bwd(bf16=True): the
    bf16 train-mode checkpoints, every product's operands rounded where
    td_block_bwd_bf16 rounds them) against autograd of the plain bf16 block
    (Bf16Linear, rounding per edge where the kernel rounds sums per node)
    on kNN and hybrid graphs (K = 40: two chunks): every tensor within 2e-2
    of its scale; the k biases, zero in exact arithmetic, within 2e-2 of the
    block's largest gradient."""
    cfg, _, _, _, model, _, rn, h, x, mlig, nbh, e_w, gh, gx = _split_setup(*SPLIT_CASES[case])
    got, want = _replay_and_autograd(model, rn, h, x, mlig, nbh, e_w, gh, gx, cfg.n_heads,
                                     dtype=torch.bfloat16)
    assert sorted(got) == sorted(want) and len(got) == 36 * cfg.num_layers + 3
    top = max(float(g.abs().max()) for g in want.values())
    worst = 0.0
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        if name.endswith("k_func.net.3.bias"):
            assert err < KERNEL_BAR * top, name
            continue
        err /= max(float(w.abs().max()), 1e-6)
        worst = max(worst, err)
        assert err < KERNEL_BAR, f"{name}: {err:.3e} of scale"
    print(f"{case}: bf16 replay vs autograd, worst {worst:.3e} of scale")


def _cli_config(tmp_path, model_cfg):
    raw, split = _mini_raw(tmp_path)
    cfg = {"data": _data_cfg(raw, split), "model": model_cfg,
           "train": {"seed": 1, "batch_size": 2, "max_iters": 2, "val_freq": 2,
                     "pos_noise_std": 0.1, "max_grad_norm": 8.0,
                     "optimizer": {"type": "adam", "lr": 1.0e-3, "weight_decay": 0,
                                   "beta1": 0.95, "beta2": 0.999},
                     "scheduler": {"type": "plateau", "factor": 0.6, "patience": 10,
                                   "min_lr": 1.0e-6}}}
    path = str(tmp_path / "train.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


CLI_ARGS = ["--device", "cpu", "--max_protein", "640", "--max_ligand", "40",
            "--train_report_iter", "1", "--dtype", "bf16"]


def test_train_cli_dtype_bf16_trains_on_the_bf16_path(tmp_path, monkeypatch):
    """`--dtype bf16` takes two steps as impl='fast_bf16' (validation stays
    float32) and writes a float32 checkpoint; --dtype defaults to f32."""
    assert train_diffusion.parser().parse_args(["x.yml"]).dtype == "f32"
    from targetdiff_tpu_torch.models.score_model import DiffusionModel

    impls = []
    loss = DiffusionModel.get_diffusion_loss

    def recording(self, *a, impl=None, **kw):
        impls.append(impl)
        return loss(self, *a, impl=impl, **kw)

    monkeypatch.setattr(DiffusionModel, "get_diffusion_loss", recording)
    model_cfg = dict(small_flagship(), num_diffusion_timesteps=12, hidden_dim=16, knn=6,
                     num_layers=1)
    out = train_diffusion.main([_cli_config(tmp_path, model_cfg), "--logdir",
                                str(tmp_path / "logs"), *CLI_ARGS])
    assert impls[:2] == ["fast_bf16", "fast_bf16"] and set(impls[2:]) == {None}
    assert out["checkpoints"] and np.isfinite(list(out["metrics"].values())).all()
    assert "training path: fast_bf16" in open(os.path.join(out["log_dir"], "log.txt")).read()
    with np.load(out["checkpoints"][-1]) as z:
        floats = [z[k].dtype for k in z.files if z[k].dtype.kind == "f"]
    assert floats and set(floats) == {np.dtype(np.float32)}
    sd = load_checkpoint(out["checkpoints"][-1])["state_dict"]
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_train_cli_dtype_bf16_refuses_an_eager_config(tmp_path):
    """An EGNN config trains eagerly: --dtype bf16 builds its bf16 model (the
    JAX CLI's --dtype bf16 --impl xla) instead of refusing, takes its steps
    with finite losses and writes a float32 checkpoint."""
    model_cfg = dict(egnn_config(num_diffusion_timesteps=12, hidden_dim=16, knn=6))
    out = train_diffusion.main([_cli_config(tmp_path, model_cfg), "--logdir",
                                str(tmp_path / "logs"), *CLI_ARGS])
    log = open(os.path.join(out["log_dir"], "log.txt")).read()
    assert "training path: eager; model dtype: torch.bfloat16" in log
    assert out["checkpoints"] and np.isfinite(list(out["metrics"].values())).all()
    with np.load(out["checkpoints"][-1]) as z:
        floats = {z[k].dtype for k in z.files if z[k].dtype.kind == "f"}
    assert floats == {np.dtype(np.float32)}
    sd = load_checkpoint(out["checkpoints"][-1])["state_dict"]
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_other_impls_raise():
    _, _, _, _, model, batch = small_setup()
    with pytest.raises(ValueError, match="fast_bf16"):
        model.get_diffusion_loss(batch, generator=torch.Generator().manual_seed(0),
                                 impl="bf16")
