"""The PyTorch port's PPO networks against the JAX package's (CPU): the MLP,
policy and value networks with the JAX weights carried across by
io.bridge.ppo_params_from_jax, the tanh-Gaussian with the same normals, the
running statistics, and the params converter's round trip.
Bars: networks rtol 1e-5 / atol 1e-6; distribution 1e-5; statistics rtol
1e-6 with atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

OBS, ACT, BATCH = 7, 3, 64


@pytest.fixture(scope="module")
def nets():
    """Both packages' PPO networks on normalized obs, the JAX params and
    normalizer (after one update on numpy data) and the port's conversions."""
    from ambersim_tpu.rl.ppo import networks as jnets
    from ambersim_tpu.rl.ppo import running_statistics as jrs
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax
    from ambersim_tpu_torch.rl.ppo import networks as tnets
    from ambersim_tpu_torch.rl.ppo import running_statistics as trs

    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    jn = jnets.make_ppo_networks(OBS, ACT, preprocess_observations_fn=jrs.normalize)
    tn = tnets.make_ppo_networks(OBS, ACT, preprocess_observations_fn=trs.normalize)
    kp, kv = jax.random.split(jax.random.PRNGKey(1))
    jparams = {"policy": jn.policy_network.init(kp), "value": jn.value_network.init(kv)}
    jnorm = jrs.update(jrs.init_state(jnp.zeros(OBS)), jnp.asarray(3 * rng.standard_normal((40, OBS)) + 1, jnp.float32))
    host = jax.tree.map(np.asarray, (jnorm, jparams))
    tnorm, tparams = ppo_params_from_jax(host, device="cpu")
    obs = (3 * rng.standard_normal((BATCH, OBS)) + 1).astype(np.float32)
    return dict(jn=jn, tn=tn, jparams=jparams, jnorm=jnorm, tparams=tparams, tnorm=tnorm, obs=obs, host=host)


@pytest.mark.parametrize("net", ["policy_network", "value_network"])
def test_networks_match_jax(nets, net):
    want = getattr(nets["jn"], net).apply(nets["jnorm"], nets["jparams"][net[: -len("_network")]], jnp.asarray(nets["obs"]))
    got = getattr(nets["tn"], net).apply(nets["tnorm"], nets["tparams"][net[: -len("_network")]], torch.as_tensor(nets["obs"]))
    assert got.shape == want.shape == ((BATCH, 2 * ACT) if net == "policy_network" else (BATCH,))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_mlp_matches_jax():
    """The bare MLP (relu, activate_final) on carried-across weights, and the
    flax init bounds: lecun_uniform weights, zero biases."""
    from ambersim_tpu.learning.architectures import MLP as JaxMLP
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax
    from ambersim_tpu_torch.learning.architectures import MLP

    x = np.random.default_rng(2).standard_normal((BATCH, OBS)).astype(np.float32)
    jm = JaxMLP(layer_sizes=[16, 8, 5], activate_final=True)
    jp = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, OBS)))
    tm = MLP(OBS, [16, 8, 5], activate_final=True)
    params = ppo_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    got = torch.func.functional_call(tm, params, (torch.as_tensor(x),))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply(jp, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    fresh = MLP(OBS, [16, 8, 5])
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    for layer in fresh.hidden:
        limit = np.sqrt(3.0 / layer.in_features)
        assert layer.weight.abs().max() <= limit and layer.weight.abs().max() > 0.8 * limit
        assert (layer.bias == 0).all()


def test_normal_tanh_matches_jax(nets):
    """log_prob, mode, postprocess, sampling and entropy with the same normals."""
    from ambersim_tpu.rl.ppo.distributions import NormalTanhDistribution as JaxDist
    from ambersim_tpu_torch.rl.ppo.distributions import NormalTanhDistribution

    rng = np.random.default_rng(4)
    logits = rng.standard_normal((BATCH, 2 * ACT)).astype(np.float32)
    raw = (1.5 * rng.standard_normal((BATCH, ACT))).astype(np.float32)
    jd, td = JaxDist(ACT), NormalTanhDistribution(ACT)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (BATCH, ACT)))  # the draws JAX's sample and entropy make
    jl, tl = jnp.asarray(logits), torch.as_tensor(logits)
    pairs = {
        "log_prob": (jd.log_prob(jl, jnp.asarray(raw)), td.log_prob(tl, torch.as_tensor(raw))),
        "mode": (jd.mode(jl), td.mode(tl)),
        "postprocess": (jd.postprocess(jnp.asarray(raw)), td.postprocess(torch.as_tensor(raw))),
        "sample": (jd.sample_no_postprocessing(jl, key), td.sample_no_postprocessing(tl, torch.as_tensor(noise))),
        "entropy": (jd.entropy(jl, key), td.entropy(tl, torch.as_tensor(noise))),
    }
    for name, (want, got) in pairs.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=name)
    # a generator draws normals of the parameters' shape
    s = td.sample_no_postprocessing(tl, torch.Generator().manual_seed(0))
    assert s.shape == (BATCH, ACT) and torch.isfinite(s).all()
    with pytest.raises(ValueError, match="noise of shape"):
        td.entropy(tl, torch.zeros(BATCH, ACT + 1))


def test_running_statistics_match_jax():
    from ambersim_tpu.rl.ppo import running_statistics as jrs
    from ambersim_tpu_torch.rl.ppo import running_statistics as trs

    rng = np.random.default_rng(6)
    a = (3 * rng.standard_normal((5, 6, OBS)) + 1).astype(np.float32)
    b = (2 * rng.standard_normal((30, OBS)) - 1).astype(np.float32)
    js = jrs.update(jrs.update(jrs.init_state(jnp.zeros(OBS)), jnp.asarray(a)), jnp.asarray(b))
    ts = trs.update(trs.update(trs.init_state(torch.zeros(OBS)), torch.as_tensor(a)), torch.as_tensor(b))
    assert float(ts.count) == float(js.count) == 60.0
    for k in ("mean", "std"):
        # atol: float32 sums taken in another order differ by an ulp of the
        # summands (6e-8 here), which rtol alone cannot absorb where the mean is near 0
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), rtol=1e-6, atol=1e-7, err_msg=k)
    x = torch.as_tensor(b)
    np.testing.assert_allclose(trs.normalize(x, ts).numpy(), np.asarray(jrs.normalize(jnp.asarray(b), js)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(trs.denormalize(trs.normalize(x, ts), ts).numpy(), b, rtol=1e-5, atol=1e-5)


def test_params_converter_round_trip(nets):
    """JAX numpy params -> port -> JAX numpy params is the identity, and
    the port's layout is nn.Linear's (out, in)."""
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax, ppo_params_to_numpy

    back = ppo_params_to_numpy((nets["tnorm"], nets["tparams"]))
    jnorm, jparams = nets["host"]
    for k in ("count", "mean", "summed_variance", "std"):
        np.testing.assert_array_equal(back[0][k], getattr(jnorm, k))
    flat_want = jax.tree_util.tree_leaves_with_path(jparams)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back[1]))
    assert len(flat_want) == len(flat_got) == 2 * (5 + 6)
    for path, v in flat_want:
        np.testing.assert_array_equal(flat_got[path], v)
    assert nets["tparams"]["policy"]["hidden.0.weight"].shape == (32, OBS)
    again = ppo_params_from_jax(back, device="cpu")
    for net in ("policy", "value"):
        for k, v in nets["tparams"][net].items():
            assert torch.equal(again[1][net][k], v), k
    with pytest.raises(TypeError, match="not a PPO params tree"):
        ppo_params_from_jax(3.0, device="cpu")


def test_deterministic_tanh_matches_jax():
    from ambersim_tpu.rl.ppo.distributions import DeterministicTanhDistribution as JaxDist
    from ambersim_tpu_torch.rl.ppo.distributions import DeterministicTanhDistribution

    p = np.random.default_rng(7).standard_normal((BATCH, ACT)).astype(np.float32)
    jd, td = JaxDist(ACT), DeterministicTanhDistribution(ACT)
    assert td.param_size == td.event_size == ACT
    tp_, jp = torch.as_tensor(p), jnp.asarray(p)
    np.testing.assert_allclose(td.mode(tp_).numpy(), np.asarray(jd.mode(jp)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.sample(tp_, None).numpy(), np.asarray(jd.sample(jp, None)), rtol=1e-6, atol=1e-6)
    assert (td.log_prob(tp_, tp_) == 0).all() and (td.entropy(tp_, None) == 0).all()


def test_networks_wrapper_checks_sizes_and_pickles():
    """The pickle-able bundle rebuilds working networks and refuses output
    sizes that do not fit the distribution or a scalar value."""
    import pickle

    from ambersim_tpu_torch.learning.architectures import MLP
    from ambersim_tpu_torch.rl.helpers import PPONetworksWrapper
    from ambersim_tpu_torch.rl.ppo.distributions import NormalTanhDistribution

    wrapper = PPONetworksWrapper(MLP(OBS, [8, 2 * ACT]), MLP(OBS, [8, 1]), NormalTanhDistribution)
    nets = pickle.loads(pickle.dumps(wrapper)).make_ppo_networks(OBS, ACT)
    g = torch.Generator().manual_seed(0)
    obs = torch.zeros(4, OBS)
    assert nets.policy_network.apply(None, nets.policy_network.init(g), obs).shape == (4, 2 * ACT)
    assert nets.value_network.apply(None, nets.value_network.init(g), obs).shape == (4,)
    with pytest.raises(ValueError, match="param_size"):
        PPONetworksWrapper(MLP(OBS, [8, ACT]), MLP(OBS, [8, 1]), NormalTanhDistribution).make_ppo_networks(OBS, ACT)
    with pytest.raises(ValueError, match="scalar"):
        PPONetworksWrapper(MLP(OBS, [8, 2 * ACT]), MLP(OBS, [8, 2]), NormalTanhDistribution).make_ppo_networks(OBS, ACT)
