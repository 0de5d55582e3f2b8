"""The port's training half of the policy-value network
(ipp_rl_tpu_torch/models in training mode, ipp_rl_tpu_torch/planners/zero/
train.py) against the JAX package's flax modules and optax train step, in
float64: the same weights (carried by ``convert.network_state_dict``) and
the same batch go through both.

Tolerances: float64 rtol 1e-9 (atol 1e-12 where a value can be ~0) for
outputs, BatchNorm statistics, parameters after SGD steps, every metric
and the per-sample value losses; the OneCycle LRs within 1e-12 of JAX's
and torch's scheduler."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipp_rl_tpu.config.schema import MCTSZeroHyperParams as JaxHP
from ipp_rl_tpu.models import layers as jl
from ipp_rl_tpu.models import networks as jn
from ipp_rl_tpu.planners.zero import train as jtrain
from ipp_rl_tpu_torch.config import MCTSZeroHyperParams
from ipp_rl_tpu_torch.convert import flax_variables, network_state_dict
from ipp_rl_tpu_torch.models import layers, networks
from ipp_rl_tpu_torch.planners.zero import train

from test_torch_zero_net import nchw, nhwc, redraw
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-12)
A = 20  # actions of the train-step network
S = 8  # plane size: with one encoder block the decoder's output is S × S


def to_f64(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


def assert_tree_close(port_tree, jax_tree, **tol):
    """Every leaf of a flax tree (from ``convert.flax_variables``) against
    the JAX one, path for path."""
    got = jax.tree_util.tree_flatten_with_path(port_tree)
    want = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jax_tree))
    assert [p for p, _ in got[0]] == [p for p, _ in want[0]]
    for (path, g), (_, w) in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path), **(tol or TOL))


def port_module(module, variables):
    module = module.to(F64)
    module.load_state_dict(network_state_dict(jax.tree_util.tree_map(np.asarray, variables)))
    return module


# ------------------------------------------------------ train-mode forward

TRAIN_LAYERS = {
    "conv_bn": (lambda: jl.ConvBN(6, (3, 3), 1, 1), lambda: layers.ConvBN(5, 6, (3, 3), 1, 1)),
    "residual_s2": (lambda: jl.ResidualBlock(6, 2, use_1x1conv=True),
                    lambda: layers.ResidualBlock(5, 6, 2, use_1x1conv=True)),
    "nonbottleneck_down": (lambda: jl.NonBottleneck1d(6, 1, use_1x1conv=True, down_sample=True),
                           lambda: layers.NonBottleneck1d(5, 6, 1, use_1x1conv=True,
                                                          down_sample=True)),
    "mix_s2": (lambda: jl.MixGlobalContext(6, 2, stride=2),
               lambda: layers.MixGlobalContext(5, 6, 2, stride=2)),
}


@pytest.mark.parametrize("case", sorted(TRAIN_LAYERS))
def test_train_mode_layer_matches_flax(case):
    """Output and updated running statistics of one block in training mode."""
    make_flax, make_port = TRAIN_LAYERS[case]
    x = np.random.default_rng(1).normal(size=(3, 9, 7, 5))
    fm = make_flax()
    variables = redraw(jax.jit(fm.init)(jax.random.key(0), jnp.asarray(x)), seed=2)
    want, mutated = jax.jit(lambda v, x: fm.apply(v, x, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    pm = port_module(make_port(), variables)
    got = pm(nchw(x), train=True)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    assert_tree_close(flax_variables(pm.state_dict())["batch_stats"], mutated["batch_stats"])
    # the inference forward after the update uses the updated statistics
    want_eval = jax.jit(fm.apply)({"params": variables["params"], **mutated}, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(pm(nchw(x))), np.asarray(want_eval), **TOL)


def test_running_var_is_flax_biased_update_not_torch_unbiased():
    """flax blends the biased batch variance into ``var``; nn.BatchNorm2d's
    own update blends the unbiased one.  The port's is flax's."""
    fm = jl.ConvBN(4, (3, 3), 1, 1)
    x = np.random.default_rng(3).normal(size=(2, 5, 5, 3))
    variables = redraw(fm.init(jax.random.key(0), jnp.asarray(x)), seed=4)
    _, mutated = fm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    want_var = np.asarray(mutated["batch_stats"]["BatchNorm_0"]["var"])
    pm = port_module(layers.ConvBN(3, 4, (3, 3), 1, 1), variables)
    conv_out = pm.Conv_0(nchw(x)).detach()
    torch_bn = torch.nn.BatchNorm2d(4, momentum=0.1).to(F64).train()
    torch_bn.load_state_dict(pm.BatchNorm_0.state_dict())
    torch_bn(conv_out)
    pm(nchw(x), train=True)
    got_var = pm.BatchNorm_0.running_var.numpy()
    np.testing.assert_allclose(got_var, want_var, **TOL)
    n = conv_out.shape[0] * conv_out.shape[2] * conv_out.shape[3]
    biased = conv_out.var(dim=(0, 2, 3), unbiased=False).numpy()
    np.testing.assert_allclose(got_var, 0.9 * pm_var0(variables) + 0.1 * biased, **TOL)
    assert not np.allclose(torch_bn.running_var.numpy(), got_var, rtol=1e-6)
    np.testing.assert_allclose(torch_bn.running_var.numpy(),
                               0.9 * pm_var0(variables) + 0.1 * biased * n / (n - 1), **TOL)


def pm_var0(variables):
    return np.asarray(variables["batch_stats"]["BatchNorm_0"]["var"])


def test_dropout_draws_from_the_generator():
    x = torch.ones((4, 8, 16, 16), dtype=F64)
    out = layers.dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    again = layers.dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    kept = out != 0
    assert abs(kept.double().mean().item() - 0.75) < 0.02
    assert torch.all(out[kept] == 1.0 / 0.75)
    assert layers.dropout(x, 0.25, False, None) is x
    assert layers.dropout(x, 0.0, True, None) is x
    # a network with dropout draws one mask per call, and none at inference
    hp = MCTSZeroHyperParams(num_channels=8, num_global_pooling_channels=4,
                             num_encoder_res_blocks=2, dropout=0.3)
    net = networks.PolicyValueNetwork(hp, A).to(F64)
    planes, mask = torch.rand((2, S, S, 16), dtype=F64), torch.ones((2, A), dtype=F64)
    a = net(planes, mask, train=True, generator=torch.Generator().manual_seed(1))[0]
    b = net(planes, mask, train=True, generator=torch.Generator().manual_seed(2))[0]
    assert not torch.allclose(a, b)
    assert torch.equal(net(planes, mask)[0], net(planes, mask)[0])


def test_policy_value_network_train_mode_matches_flax():
    hp = dict(num_channels=8, num_global_pooling_channels=4, num_encoder_res_blocks=4,
              use_autoencoder=False)
    fnet = jn.PolicyValueNetwork(hp=JaxHP(**hp), num_actions=A)
    rng = np.random.default_rng(5)
    planes, mask = rng.random((3, 12, 12, 16)), (rng.random((3, A)) > 0.4).astype(np.float64)
    variables = redraw(jax.jit(fnet.init)(jax.random.key(0), jnp.asarray(planes),
                                          jnp.asarray(mask)), 6)
    want, mutated = jax.jit(lambda v, p, m: fnet.apply(v, p, m, train=True,
                                                       mutable=["batch_stats"]))(
        variables, jnp.asarray(planes), jnp.asarray(mask))
    net = port_module(networks.PolicyValueNetwork(MCTSZeroHyperParams(**hp), A), variables)
    got = net(torch.from_numpy(planes), torch.from_numpy(mask), train=True)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(want[1]), **TOL)
    # the encoder's shared blocks blend their statistics once per call
    assert_tree_close(flax_variables(net.state_dict())["batch_stats"], mutated["batch_stats"])


# ------------------------------------------------------------ train step

STEP_CASES = {
    # the clip never triggers
    "plain": dict(num_encoder_res_blocks=2, max_grad_norm=1e6),
    # every loss term, PER weights, and a clip that triggers every step
    "all_terms_clipped": dict(num_encoder_res_blocks=1, max_grad_norm=0.5, use_reward_target=True,
                              use_autoencoder=True, entropy_regularization_coeff=0.05,
                              weight_decay=1e-3),
}
LRS = (5e-3, 2e-2, 1e-2)


def step_hp(case):
    return dict(num_channels=16, num_global_pooling_channels=4, **STEP_CASES[case])


def batch_arrays(seed=7, B=6, weighted=True):
    rng = np.random.default_rng(seed)
    policy = rng.random((B, A))
    mask = (rng.random((B, A)) > 0.3).astype(np.float64)
    policy = policy * mask / (policy * mask).sum(-1, keepdims=True)
    return dict(planes=rng.random((B, S, S, 16)), policy=policy, value=rng.uniform(0, 2, B),
                reward=rng.uniform(0, 1, B), valid_mask=mask,
                weight=rng.uniform(0.3, 1.0, B) if weighted else np.ones(B))


def jax_state(jhp, key=0):
    """``init_train_state``'s network and state, in float64 (its init
    jitted: one compile in place of one per operation)."""
    jnet = jn.PolicyValueNetwork(hp=jhp, num_actions=A)
    variables = to_f64(jax.jit(jnet.init)(jax.random.key(key), jnp.zeros((1, S, S, 16)),
                                          jnp.ones((1, A))))
    params = variables["params"]
    st = jtrain.ZeroTrainState(params=params, batch_stats=variables["batch_stats"],
                               opt_state=jtrain.make_optimizer(jhp).init(params),
                               step=jnp.int32(0))
    return jnet, st


class _JaxCfg:
    """What ``init_train_state`` reads of a config."""

    num_actions = A

    class environment:
        num_cells = S


def port_state(hp, jst):
    net, st = train.init_train_state(_JaxCfg, hp, torch.Generator().manual_seed(0),
                                     device="cpu", dtype=F64)
    net.load_state_dict(network_state_dict(jax.tree_util.tree_map(np.asarray, jst.variables())))
    return st


def compare_states(st, jst):
    got = flax_variables(st.variables())
    assert_tree_close(got["params"], jst.params)
    assert_tree_close(got["batch_stats"], jst.batch_stats)


def compare_step_outputs(metrics, value_l, jmetrics, jvalue_l):
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(value_l.numpy(), np.asarray(jvalue_l), **TOL)


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def stepped(request):
    """Three SGD steps in both packages from the same weights and batch."""
    case = request.param
    jhp, hp = JaxHP(**step_hp(case)), MCTSZeroHyperParams(**step_hp(case))
    jnet, jst = jax_state(jhp)
    st = port_state(hp, jst)
    arrays = batch_arrays(weighted=case != "plain")
    jbatch = jtrain.TrainBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    batch = train.TrainBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    jstep, step = jtrain.make_train_step(jnet, jhp), train.make_train_step(hp)
    out = []
    for lr in LRS:
        jst, jm, jv = jstep(jst, jbatch, jax.random.key(1), lr)
        st, m, v = step(st, batch, None, lr)
        out.append((st, m, v, jst, jm, jv))
    return case, hp, jhp, jstep, step, jbatch, batch, out


def test_train_steps_match_jax(stepped):
    case, hp, *_, out = stepped
    for st, m, v, jst, jm, jv in out:
        compare_step_outputs(m, v, jm, jv)
    st, *_, jst, _, _ = out[-1]
    compare_states(st, jst)
    assert st.step == int(jst.step) == len(LRS)
    norms = [m["grad_norm"].item() for _, m, *_ in out]
    if case == "plain":
        assert all(n < hp.max_grad_norm for n in norms)
    else:
        assert all(n > hp.max_grad_norm for n in norms)
        assert {"reward_loss", "reconstruction_loss"} <= set(out[0][1])


def test_reset_optimizer_matches_jax(stepped):
    """A fresh optimiser (zero momentum, step 0) after the three steps, then
    one more step in both packages."""
    case, hp, jhp, jstep, step, jbatch, batch, out = stepped
    st, *_, jst, _, _ = out[-1]
    st, jst = train.reset_optimizer(hp, st), jtrain.reset_optimizer(jhp, jst)
    assert st.step == 0 and len(st.optimizer.state) == 0
    st, m, v = step(st, batch, None, 3e-3)
    jst, jm, jv = jstep(jst, jbatch, jax.random.key(2), 3e-3)
    compare_step_outputs(m, v, jm, jv)
    compare_states(st, jst)


def test_split_train_step_matches_jax():
    kw = dict(num_channels=16, num_global_pooling_channels=4, num_encoder_res_blocks=2,
              shared_network=False, use_reward_target=True, entropy_regularization_coeff=0.05,
              max_grad_norm=2.0)
    jhp, hp = JaxHP(**kw), MCTSZeroHyperParams(**kw)
    # init_split_train_state's networks, their inits jitted, in float64
    jnets = (jn.PolicyNetwork(hp=jhp, num_actions=A), jn.ValueNetwork(hp=jhp, num_actions=A))
    x, m = jnp.zeros((1, S, S, 16)), jnp.ones((1, A))
    inits = (jax.jit(jnets[0].init)(jax.random.key(3), x, m),
             jax.jit(jnets[1].init)(jax.random.key(4), x))
    tx = jtrain.make_optimizer(jhp)

    def f64(variables):
        params = to_f64(variables["params"])
        return jtrain.ZeroTrainState(params=params, batch_stats=to_f64(variables["batch_stats"]),
                                     opt_state=tx.init(params), step=jnp.int32(0))

    jst = jtrain.SplitTrainState(*(f64(v) for v in inits))
    _, st = train.init_split_train_state(_JaxCfg, hp, torch.Generator().manual_seed(0),
                                         device="cpu", dtype=F64)
    for part in ("policy", "value"):
        getattr(st, part).net.load_state_dict(network_state_dict(
            jax.tree_util.tree_map(np.asarray, getattr(jst, part).variables())))
    arrays = batch_arrays(seed=9)
    jbatch = jtrain.TrainBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    batch = train.TrainBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    jst, jm, jv = jtrain.make_split_train_step(jnets, jhp)(jst, jbatch, jax.random.key(4), 1e-2)
    st, m, v = train.make_split_train_step(hp)(st, batch, None, 1e-2)
    compare_step_outputs(m, v, jm, jv)
    for part in ("policy", "value"):
        compare_states(getattr(st, part), getattr(jst, part))


@pytest.mark.parametrize("epochs,num_batches", [(3, 7), (1, 1), (2, 50), (3, 128)])
def test_onecycle_lr_matches_jax_and_torch(epochs, num_batches):
    """tests/test_zero.py's four schedule lengths: the port's LR equals the
    JAX package's and torch's OneCycleLR at every step."""
    hp, jhp = MCTSZeroHyperParams(), JaxHP()
    total = epochs * num_batches
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=hp.learning_rate)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=hp.max_learning_rate, epochs=epochs, steps_per_epoch=num_batches,
        div_factor=hp.max_learning_rate / hp.learning_rate, final_div_factor=100,
        anneal_strategy="linear", three_phase=True, pct_start=0.40)
    for step in range(total):
        got = train.onecycle_lr(hp, step, total)
        assert got == jtrain.onecycle_lr(jhp, step, total)
        want = opt.param_groups[0]["lr"]
        assert abs(got - want) < 1e-12 * max(1.0, abs(want)) + 1e-15
        opt.step()
        sched.step()


@pytest.mark.parametrize("max_norm", [2.0, 13.0, 20.0])
def test_clip_follows_optax_not_torch(max_norm):
    """The port's SGD step clips as optax does: gradients scaled by
    max_norm / norm with no epsilon when norm ≥ max_norm (at norm =
    max_norm too), untouched below; torch's clip_grad_norm_ divides by
    norm + 1e-6 and leaves norm = max_norm alone."""
    lin = torch.nn.Linear(2, 1).to(F64)
    with torch.no_grad():  # from zero, p0 - p is the update exactly, whatever the RNG holds
        for p in lin.parameters():
            p.zero_()
    grads = [torch.tensor([[3.0, 4.0]], dtype=F64), torch.tensor([12.0], dtype=F64)]  # norm 13
    p0 = [p.detach().clone() for p in lin.parameters()]
    for p, g in zip(lin.parameters(), grads):
        p.grad = g.clone()
    hp = MCTSZeroHyperParams(max_grad_norm=max_norm, momentum=0.0, weight_decay=0.0)
    state = train.ZeroTrainState(lin, train.make_optimizer(hp, lin))
    norm = train._sgd_step(hp, state, 1.0)
    assert norm.item() == 13.0 and state.step == 1
    want = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g.numpy()) for g in grads],
                                                     None)[0]
    for p, before, w in zip(lin.parameters(), p0, want):
        np.testing.assert_array_equal((before - p.detach()).numpy(), np.asarray(w))


def test_cudnn_deterministic_scopes_the_flags():
    """A train step wrapped by ``cudnn_deterministic`` runs under cuDNN's
    deterministic algorithms without autotuning, and the caller's settings
    come back after each call, also when the step raises."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    try:
        cudnn.deterministic, cudnn.benchmark = False, True
        step = train.cudnn_deterministic(lambda x: (x, cudnn.deterministic, cudnn.benchmark))
        assert step(3) == (3, True, False)
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
        with pytest.raises(ZeroDivisionError):
            train.cudnn_deterministic(lambda: 1 / 0)()
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
