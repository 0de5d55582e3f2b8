"""The port's policy-value network (ipp_rl_tpu_torch/models) against the JAX
package's flax modules, with the flax variables carried across by
``convert.network_state_dict``; the port's msgpack reader against flax's;
the committed checkpoint's forward against JAX's ``predict_fn``.

Every flax leaf is first redrawn from a seeded numpy generator (BatchNorm
variances positive), so no layer is an identity and every weight counts.
Tolerances: float64 rtol 1e-9 (the same operations; only the order of the
convolutions' sums differs), float32 rtol 1e-4 with atol 1e-6 for the
log-probabilities near 0; the checkpoint's forward atol 1e-4 (float32)."""

import dataclasses
import pathlib

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_rl_tpu.config.schema import MCTSZeroHyperParams as JaxHP
from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
from ipp_rl_tpu.models import layers as jl
from ipp_rl_tpu.models import networks as jn
from ipp_rl_tpu.planners.zero import train as jtrain
from ipp_rl_tpu.planners.zero.features import feature_planes as j_planes
from ipp_rl_tpu.planners.zero.features import init_history as j_init_history
from ipp_rl_tpu.planners.zero.features import push_history as j_push
from ipp_rl_tpu_torch import serialization
from ipp_rl_tpu_torch.config import CONFIG_DIR, MCTSZeroHyperParams, load_config
from ipp_rl_tpu_torch.convert import network_state_dict
from ipp_rl_tpu_torch.models import layers, networks
from ipp_rl_tpu_torch.planners.zero import train
from ipp_rl_tpu_torch.planners.zero.learn import load_checkpoint

from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "runs" / "zero_canon_r5_best" / "checkpoints" / "shared_net.trained_model.ckpt"
TOL = {np.float64: dict(rtol=1e-9, atol=0.0), np.float32: dict(rtol=1e-4, atol=1e-6)}
# the committed checkpoint's hyper-parameters (tests/test_learning_artifact.py)
CKPT_HP = dict(num_channels=64, num_encoder_res_blocks=6, num_global_pooling_channels=32,
               max_valid_action_distance=11.5, unfloored_value_head=True)


def narrow_hp(**kw):
    """8 channels, 4 pooling channels and 10 encoder blocks, so that
    mix_s2 (i = 3) and mix_s1 (i = 6, 9) both run."""
    base = dict(num_channels=8, num_global_pooling_channels=4, num_encoder_res_blocks=10)
    base.update(kw)
    return JaxHP(**base), MCTSZeroHyperParams(**base)


def redraw(variables, seed, dtype=np.float64):
    """Every leaf of a flax variable tree replaced by seeded random values
    in ``dtype``: flax computes BatchNorm's factor in the variables' dtype,
    so a float64 comparison needs float64 variables."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape), dtype)
        scale = 1.0 / np.sqrt(np.prod(x.shape[:-1])) if name == "kernel" else 0.3
        return jnp.asarray(rng.normal(0.0, scale, x.shape), dtype)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(jnp.asarray, variables))


def port_module(module, variables, dtype):
    module = module.to(dtype).eval()
    module.load_state_dict(network_state_dict(jax.tree_util.tree_map(np.asarray, variables)))
    return module


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


LAYER_CASES = {
    "conv_bn": (lambda: jl.ConvBN(6, (7, 7), 2, 3), lambda: layers.ConvBN(5, 6, (7, 7), 2, 3)),
    "residual_s2": (lambda: jl.ResidualBlock(6, 2, use_1x1conv=True),
                    lambda: layers.ResidualBlock(5, 6, 2, use_1x1conv=True)),
    "residual_relu": (lambda: jl.ResidualBlock(5, 1, use_silu=False),
                      lambda: layers.ResidualBlock(5, 5, 1, use_silu=False)),
    "nonbottleneck_down": (lambda: jl.NonBottleneck1d(6, 1, use_1x1conv=True, down_sample=True),
                           lambda: layers.NonBottleneck1d(5, 6, 1, use_1x1conv=True,
                                                          down_sample=True)),
    "nonbottleneck_dilated": (lambda: jl.NonBottleneck1d(5, 2),
                              lambda: layers.NonBottleneck1d(5, 5, 2)),
    "mix_s1": (lambda: jl.MixGlobalContext(5, 2, stride=1),
               lambda: layers.MixGlobalContext(5, 5, 2, stride=1)),
    "mix_s2": (lambda: jl.MixGlobalContext(6, 2, stride=2),
               lambda: layers.MixGlobalContext(5, 6, 2, stride=2)),
    "decoder": (lambda: jl.Decoder(16), lambda: layers.Decoder(16)),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_flax(case, dtype):
    make_flax, make_port = LAYER_CASES[case]
    channels = 16 if case == "decoder" else 5
    x = np.random.default_rng(1).normal(size=(2, 13, 11, channels)).astype(dtype)
    fm = make_flax()
    variables = redraw(fm.init(jax.random.key(0), jnp.asarray(x)), seed=2, dtype=dtype)
    want = np.asarray(fm.apply(variables, jnp.asarray(x)))
    got = port_module(make_port(), variables, getattr(torch, np.dtype(dtype).name))(nchw(x))
    got = got.detach().numpy() if case == "decoder" else nhwc(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_global_pooling_is_mean_then_max():
    x = np.random.default_rng(3).normal(size=(2, 4, 5, 3))
    want = np.asarray(jl.GlobalPooling().apply({}, jnp.asarray(x)))
    got = layers.GlobalPooling()(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15)  # the mean's sum order may differ
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])  # the max is exact


@pytest.mark.parametrize("unfloored", [False, True])
def test_heads_match_flax(unfloored):
    x = np.random.default_rng(4).normal(size=(3, 5, 5, 8))
    mask = (np.random.default_rng(5).random((3, 11)) > 0.4).astype(np.float64)
    fv = jl.ValueHead(8, 3, num_global_pooling_channels=4, unfloored=unfloored)
    v_vars = redraw(fv.init(jax.random.key(0), jnp.asarray(x)), seed=6)
    want_v, _ = fv.apply(v_vars, jnp.asarray(x))
    pv = port_module(layers.ValueHead(8, 3, num_global_pooling_channels=4, unfloored=unfloored),
                     v_vars, torch.float64)
    got_v, _ = pv(nchw(x))
    np.testing.assert_allclose(got_v.detach().numpy(), np.asarray(want_v), **TOL[np.float64])

    fp = jl.PolicyHead(8, 3, 11, num_global_pooling_channels=4)
    p_vars = redraw(fp.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask)), seed=7)
    want_p = fp.apply(p_vars, jnp.asarray(x), jnp.asarray(mask))
    pp = port_module(layers.PolicyHead(8, 3, 11, num_global_pooling_channels=4), p_vars,
                     torch.float64)
    got_p = pp(nchw(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(want_p), **TOL[np.float64])


def network_inputs(A, C, dtype, seed=8, batch=2, size=36):
    rng = np.random.default_rng(seed)
    planes = rng.random((batch, size, size, C)).astype(dtype)
    mask = (rng.random((batch, A)) > 0.5).astype(dtype)
    return planes, mask


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("separable", [True, False])
def test_policy_value_network_matches_flax(separable, dtype):
    jhp, hp = narrow_hp(use_separable_conv_layers=separable, unfloored_value_head=separable,
                        use_autoencoder=not separable)
    A = 72
    planes, mask = network_inputs(A, 16, dtype)
    fnet = jn.PolicyValueNetwork(hp=jhp, num_actions=A)
    variables = redraw(fnet.init(jax.random.key(0), jnp.asarray(planes), jnp.asarray(mask)), 9,
                       dtype)
    want = fnet.apply(variables, jnp.asarray(planes), jnp.asarray(mask))
    net = port_module(networks.PolicyValueNetwork(hp, A), variables,
                      getattr(torch, np.dtype(dtype).name))
    assert net.encoder.plan[3] == "mix_s2" and net.encoder.plan[6] == "mix_s1"
    got = net(torch.from_numpy(planes), torch.from_numpy(mask))
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL[dtype])


def test_split_predict_matches_flax():
    jhp, hp = narrow_hp(shared_network=False, num_encoder_res_blocks=4)
    A = 72
    planes, mask = network_inputs(A, 16, np.float64, seed=10)
    fnets = (jn.PolicyNetwork(hp=jhp, num_actions=A), jn.ValueNetwork(hp=jhp, num_actions=A))
    jv = {
        "policy": redraw(fnets[0].init(jax.random.key(0), jnp.asarray(planes),
                                       jnp.asarray(mask)), 11),
        "value": redraw(fnets[1].init(jax.random.key(1), jnp.asarray(planes)), 12),
    }
    want_p, want_v = jtrain.split_predict_fn(fnets)(jv, jnp.asarray(planes), jnp.asarray(mask))
    nets = (networks.PolicyNetwork(hp, A), networks.ValueNetwork(hp))
    variables = {
        k: port_module(n, jv[k], torch.float32).state_dict()
        for k, n in zip(("policy", "value"), nets)
    }
    got_p, got_v = train.split_predict_fn(nets)(variables, torch.from_numpy(planes),
                                                torch.from_numpy(mask))
    assert got_p.dtype == torch.float32 and got_v.dtype == torch.float32
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6)


def test_convert_refuses_unknown_and_missing_leaves():
    jhp, hp = narrow_hp(num_encoder_res_blocks=2)
    planes, mask = network_inputs(72, 16, np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jn.PolicyValueNetwork(hp=jhp, num_actions=72).init(
            jax.random.key(0), jnp.asarray(planes), jnp.asarray(mask)))
    net = networks.PolicyValueNetwork(hp, 72)
    net.load_state_dict(network_state_dict(variables))  # exact: loads strictly
    del variables["params"]["value_head"]["head"]["bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        net.load_state_dict(network_state_dict(variables))
    variables["params"]["value_head"]["head"]["extra"] = np.zeros(3)
    with pytest.raises(KeyError):
        network_state_dict(variables)


def test_msgpack_reader_is_bitwise_flax():
    data = CKPT.read_bytes()
    got = serialization.msgpack_restore(data)
    want = flax.serialization.msgpack_restore(data)
    g_leaves, g_tree = jax.tree_util.tree_flatten_with_path(got)
    w_leaves, w_tree = jax.tree_util.tree_flatten_with_path(want)
    assert g_tree == w_tree and len(g_leaves) == 98
    for (gp, g), (wp, w) in zip(g_leaves, w_leaves):
        assert gp == wp and g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_msgpack_reader_other_types():
    tree = {"ints": [0, 127, 128, 70000, 2 ** 40, -1, -33, -200, -2 ** 40], "f": 1.5,
            "flags": [True, False, None], "s": "x" * 40, "b": b"yy",
            "scalar": np.float32(2.5), "z": complex(1.0, -2.0), "empty": {},
            "arr": np.arange(6, dtype=np.int16).reshape(2, 3)}
    data = flax.serialization.msgpack_serialize(tree)
    got = serialization.msgpack_restore(data)
    want = flax.serialization.msgpack_restore(data)
    np.testing.assert_array_equal(got.pop("arr"), want.pop("arr"))
    assert got == want and type(got["scalar"]) is np.float32
    with pytest.raises(ValueError, match="truncated"):
        serialization.msgpack_restore(data[:-3])


@pytest.fixture(scope="module")
def canonical_planes():
    """B = 2 canonical 100×100 planes from the JAX package's feature build."""
    cfg_path = str(ROOT / "ipp_rl_tpu" / "config" / "example.yaml")
    from ipp_rl_tpu.config.schema import load_config as jax_load_config

    jcfg = jax_load_config(cfg_path)
    jhp = JaxHP(**CKPT_HP)
    world = JaxWorld(jcfg)
    state = world.init_state(jax.random.key(3), 2)
    hist = jax.vmap(lambda _: j_init_history(jcfg, jhp, jnp.float32))(jnp.arange(2))
    hist = jax.vmap(j_push)(hist, state.cov, state.pos, state.budget / 200.0)
    planes = jax.vmap(lambda h, m: j_planes(world, jhp, h, mean=m))(hist, state.mean)
    mask = np.asarray(jax.vmap(lambda p, b: (jnp.linalg.norm(world.actions_xyz - p, axis=-1)
                                             < 11.5) & (b > 0))(state.pos, state.budget))
    return jcfg, jhp, np.array(planes, np.float32), mask.astype(np.float32)


def test_checkpoint_forward_matches_jax(canonical_planes):
    jcfg, jhp, planes, mask = canonical_planes
    assert planes.shape == (2, 100, 100, 16)
    jnet, state0 = jtrain.init_train_state(jcfg, jhp, jax.random.key(0))
    with open(CKPT, "rb") as f:
        jvars = flax.serialization.from_bytes(state0.variables(), f.read())
    want_p, want_v = jtrain.predict_fn(jnet)(jvars, jnp.asarray(planes), jnp.asarray(mask))

    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    hp = MCTSZeroHyperParams(**CKPT_HP)
    net = load_checkpoint(str(CKPT), train.init_network(
        cfg, hp, torch.Generator().manual_seed(0), device="cpu"))
    predict = train.predict_fn(net)
    got_p, got_v = predict(net.state_dict(), torch.from_numpy(planes), torch.from_numpy(mask))
    assert got_p.dtype == torch.float32
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-4)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-4, rtol=1e-4)

    # bf16 inference returns float32 outputs near the float32 ones, as the
    # JAX package requires of its own (tests/test_zero_extras.py)
    p16, v16 = train.predict_fn(net, dtype=torch.bfloat16)(
        net.state_dict(), torch.from_numpy(planes), torch.from_numpy(mask))
    assert p16.dtype == torch.float32 and v16.dtype == torch.float32
    np.testing.assert_allclose(p16.numpy(), got_p.numpy(), atol=0.03)
    np.testing.assert_allclose(v16.numpy(), got_v.numpy(), rtol=0.08, atol=0.05)


def test_init_network_draws_like_flax():
    """The seeded init gives flax's statistics: lecun-normal kernels
    (std 1/√fan_in, truncated at 2σ), zero biases, identity BatchNorm."""
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    hp = MCTSZeroHyperParams(num_channels=32, num_encoder_res_blocks=4,
                             num_global_pooling_channels=8)
    a = train.init_network(cfg, hp, torch.Generator().manual_seed(1), device="cpu")
    b = train.init_network(cfg, hp, torch.Generator().manual_seed(1), device="cpu")
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    w = a.encoder.stem.Conv_0.weight  # fan_in 7·7·16
    assert abs(w.std().item() * np.sqrt(7 * 7 * 16) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(7 * 7 * 16) + 1e-7
    assert not a.training
    assert torch.equal(a.policy_head.head.bias, torch.zeros_like(a.policy_head.head.bias))
    assert torch.equal(a.encoder.stem.BatchNorm_0.running_var,
                       torch.ones_like(a.encoder.stem.BatchNorm_0.running_var))
    assert dataclasses.asdict(hp)["num_channels"] == 32
