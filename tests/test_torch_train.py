"""The port's optimizer, trainer and AUROC on the CPU, against the JAX
package: the optax chain fed the same gradients, JAX make_train_step(xla)
with the same draws, the Lt EMA with duplicate timesteps, the importance
sampler's switch, and sklearn's roc_auc_score."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from targetdiff_tpu import trainer as jtrainer
from targetdiff_tpu.config import Config as JConfig
from targetdiff_tpu.ops import diffusion as JD
from targetdiff_tpu.utils import train as JTU
from targetdiff_tpu_torch import trainer as T
from targetdiff_tpu_torch.config import Config
from targetdiff_tpu_torch.ops import diffusion as D
from targetdiff_tpu_torch.utils import train as TU
from tests.test_torch_block_vjp import jax_draws
from tests.test_torch_score_model import small_setup

torch.set_num_threads(2)

OPT = dict(type="adam", lr=5e-4, weight_decay=0.0, beta1=0.95, beta2=0.999, max_grad_norm=8.0)


@pytest.mark.parametrize("weight_decay,grad_scale", [(0.0, 1.0), (0.0, 50.0), (1e-2, 50.0)])
def test_optimizer_matches_optax(weight_decay, grad_scale):
    """Two steps from the same params and gradients; grad_scale 50 puts the
    global norm above 8, so clipping is active."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * grad_scale).astype(np.float32) for s in shapes]
             for _ in range(2)]
    cfg = dict(OPT, weight_decay=weight_decay)
    jopt = JTU.get_optimizer(JConfig(cfg))
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = TU.get_optimizer(Config(cfg), tp)
    for g in grads:
        upd, jstate = jopt.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        norm = topt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
    assert (float(optax.global_norm(grads[0])) > 8.0) == (grad_scale > 1)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=1e-6, rtol=0)


def test_learning_rate_setter_and_schedulers():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = TU.get_optimizer(Config(OPT), [p])
    TU.set_learning_rate(opt, 3.3e-4)
    assert TU.get_learning_rate(opt) == pytest.approx(3.3e-4)
    s = TU.get_scheduler(Config(type="plateau", factor=0.5, patience=2, min_lr=1e-5),
                         Config(OPT))
    for metric in (1.0, 0.9, 0.95, 0.95, 0.95):
        lr = s.step(metric)
    assert lr == pytest.approx(2.5e-4)
    w = TU.get_scheduler(Config(type="warmup_plateau", multiplier=2.0, total_epoch=2, factor=0.5,
                                patience=2, min_lr=1e-5), Config(OPT))
    assert [w.step(1.0), w.step(1.0)] == pytest.approx([7.5e-4, 1e-3])


def test_train_step_matches_jax_xla_step():
    """Same params, batch and draws (pos_noise_std 0, symmetric time): the
    port's step reports the JAX step's loss and pre-clip gradient norm."""
    _, jmodel, params, jbatch, model, batch = small_setup()
    jopt = JTU.get_optimizer(JConfig(OPT))
    T_ = jmodel.num_timesteps
    state = jtrainer.TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32),
                                jnp.zeros((T_,), jnp.float32), jnp.zeros((T_,), jnp.float32))
    key = jax.random.PRNGKey(3)
    _, metrics = jtrainer.make_train_step(jmodel, jopt, impl="xla", remat=False)(state, jbatch,
                                                                                  key)
    # replay the JAX step's key splits to inject its draws
    _, _, key_loss = jax.random.split(key, 3)
    key_t, _, _ = jax.random.split(key_loss, 3)
    t, _ = JD.sample_time_symmetric(key_t, jbatch.num_graphs, jmodel.num_timesteps)
    eps, u = jax_draws(key_loss, jbatch, jmodel.num_classes)
    tstate = T.create_train_state(model, TU.get_optimizer(Config(OPT), model.parameters()))
    step = T.make_train_step(model, pos_noise_std=0.0)
    tstate, tm = step(tstate, batch, None, time_step=torch.from_numpy(np.asarray(t)).long(),
                      pos_noise=eps, v_uniform=u)
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(metrics[k])) <= 1e-4 * abs(float(metrics[k])), k
    assert tstate.step == 1 and float(tstate.Lt_count.sum()) == batch.num_graphs


def test_lt_ema_averages_duplicate_timesteps():
    _, _, _, _, model, _ = small_setup()
    st = T.create_train_state(model, TU.get_optimizer(Config(OPT), model.parameters()))
    T.update_Lt_ema(st, torch.tensor([3, 3, 5]), torch.tensor([1.0, 3.0, 4.0]))
    assert st.Lt_history[3] == pytest.approx(2.0) and st.Lt_history[5] == pytest.approx(4.0)
    assert st.Lt_count.tolist()[3:6] == [2.0, 0.0, 1.0]
    T.update_Lt_ema(st, torch.tensor([3, 3]), torch.tensor([6.0, 6.0]))
    assert st.Lt_history[3] == pytest.approx(0.9 * 2.0 + 0.1 * 6.0)
    assert st.Lt_history[5] == pytest.approx(4.0)  # untouched bucket keeps its value


def test_importance_sampler_switches_when_every_bucket_is_ready():
    T_ = 10
    hist = torch.zeros(T_)
    hist[6] = 1e6  # importance sampling then picks t = 6 almost surely
    count = torch.full((T_,), 11.0)
    gen = torch.Generator().manual_seed(0)
    t, pt = D.sample_time_importance(64, hist, count, gen)
    assert bool((t == 6).all()) and float(pt[0]) > 0.99
    count[4] = 10.0  # one bucket not ready -> symmetric pairs t, T-1-t
    t, pt = D.sample_time_importance(64, hist, count, gen)
    assert bool((t[:31] + t[33:] == T_ - 1).all()) and float(pt[0]) == pytest.approx(1 / T_)


def test_atom_auroc_matches_sklearn():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 5, 200)
    prob = np.round(rng.random((200, 5)), 1)  # rounded: ties
    prob[np.arange(200), y] += 0.3
    mask = rng.random(200) > 0.1
    assert T.atom_auroc(y, prob, mask) == pytest.approx(jtrainer.atom_auroc(y, prob, mask),
                                                        abs=1e-12)
