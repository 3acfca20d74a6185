"""The port's encoder, critics, spectral norm, losses, optimizer and schedule
against the JAX package, on the CPU.

Parameters are drawn by the JAX package's initializers and handed to the
port as numpy arrays (the same path ``interop/from_jax.py`` takes); inputs
come from numpy seeds. Tolerances: float32 1e-5 (same math, other summation
order; 1e-4 relative for gradients through spectral norm, whose σ divides);
bfloat16 compute against JAX's bf16 compute 2e-2 relative to the largest
magnitude (the two frameworks round bf16 products at different places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu import losses as jl
from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.data.pipeline import GestureArrays as JaxGestureArrays
from wordgesture_gan_tpu.data.pipeline import within_word_diversity as jax_within_word_diversity
from wordgesture_gan_tpu.models import gan as jg
from wordgesture_gan_tpu.models import layers as jlayers
from wordgesture_gan_tpu.train.schedules import cosine_annealing_lr as jax_cosine
from wordgesture_gan_tpu.train.state import make_optimizer
from wordgesture_gan_tpu_torch import losses as tl
from wordgesture_gan_tpu_torch.configs import ModelConfig
from wordgesture_gan_tpu_torch.data.pipeline import GestureArrays, within_word_diversity
from wordgesture_gan_tpu_torch.models import gan as tg
from wordgesture_gan_tpu_torch.models import layers as tlayers
from wordgesture_gan_tpu_torch.train.schedules import cosine_annealing_lr
from wordgesture_gan_tpu_torch.train.state import adam_init, apply_update
from wordgesture_gan_tpu_torch.utils.tree import tree_leaves, tree_map
from wordgesture_gan_tpu_torch.utils import prng

FIELDS = dict(seq_length=16, latent_dim=4, enc_hidden_dims=(24, 16), disc_hidden_dims=(24, 12))


def _configs(**overrides):
    fields = {**FIELDS, **overrides}
    return JaxModelConfig(**fields), ModelConfig(**fields)


def _torch_tree(tree, grad=False):
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), requires_grad=grad), tree)


def _numpy(tree):
    return tree_map(lambda t: t.detach().float().numpy(), tree)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 2e-2 * scale


def _gestures(seed, B, L=16):
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1, 1, (B, L, 3)).astype(np.float32)
    g[..., 2] = np.sort(rng.uniform(0, 1, (B, L)), axis=1)
    return g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    jcfg, tcfg = _configs(compute_dtype=dtype)
    params = jax.device_get(jg.encoder_init(jax.random.PRNGKey(0), jcfg))
    x = _gestures(1, 6)
    eps = np.random.default_rng(2).normal(size=(6, 4)).astype(np.float32)
    ref = jg.encoder_apply(params, jnp.asarray(x), None, jcfg, eps=jnp.asarray(eps))
    with torch.no_grad():
        out = tg.encoder_apply(_torch_tree(params), torch.from_numpy(x), tcfg,
                               eps=torch.from_numpy(eps))
    for got, want in zip(out, ref):
        assert got.dtype == torch.float32
        _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("temporal", [True, False])
@pytest.mark.parametrize("update", [True, False])
def test_critic_matches_jax(temporal, dtype, update):
    """Scores, every feature tap and the advanced u of both critics."""
    jcfg, tcfg = _configs(compute_dtype=dtype, use_temporal_disc=temporal)
    params, sn = jax.device_get(jg.disc_init(jax.random.PRNGKey(3), jcfg))
    x = _gestures(4, 5)
    ref_scores, ref_feats, ref_sn = jg.disc_apply(params, sn, jnp.asarray(x), update, jcfg)
    with torch.no_grad():
        scores, feats, new_sn = tg.disc_apply(_torch_tree(params), _torch_tree(sn),
                                              torch.from_numpy(x), update, tcfg)
    assert scores.dtype == torch.float32 and scores.shape == (5, 1)
    _close(scores.numpy(), ref_scores, dtype)
    assert len(feats) == len(ref_feats)
    for got, want in zip(feats, ref_feats):
        _close(got.float().numpy(), want, dtype)
    for got, want in zip(tree_leaves(_numpy(new_sn)), jax.tree.leaves(ref_sn)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_two_sequential_critic_forwards_advance_u_twice():
    jcfg, tcfg = _configs()
    params, sn = jax.device_get(jg.disc_init(jax.random.PRNGKey(5), jcfg))
    a, b = _gestures(6, 4), _gestures(7, 4)
    _, _, sn1 = jg.disc_apply(params, sn, jnp.asarray(a), True, jcfg)
    ref_scores, _, sn2 = jg.disc_apply(params, sn1, jnp.asarray(b), True, jcfg)
    tp = _torch_tree(params)
    with torch.no_grad():
        _, _, u1 = tg.disc_apply(tp, _torch_tree(sn), torch.from_numpy(a), True, tcfg)
        scores, _, u2 = tg.disc_apply(tp, u1, torch.from_numpy(b), True, tcfg)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=1e-5)
    for got, want in zip(tree_leaves(_numpy(u1)), jax.tree.leaves(sn1)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    for got, want, first in zip(tree_leaves(_numpy(u2)), jax.tree.leaves(sn2),
                                jax.tree.leaves(sn1)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
        if want.size > 1:   # a one-column layer's u is ±1 whatever the iteration
            assert not np.allclose(np.asarray(want), np.asarray(first), atol=0, rtol=0)


@pytest.mark.parametrize("temporal", [True, False])
def test_critic_gradients_through_spectral_norm_match_jax(temporal):
    """σ is differentiated with respect to W; u and v are not."""
    jcfg, tcfg = _configs(use_temporal_disc=temporal)
    params, sn = jax.device_get(jg.disc_init(jax.random.PRNGKey(8), jcfg))
    x = _gestures(9, 4)

    def loss(p):
        scores, feats, _ = jg.disc_apply(p, sn, jnp.asarray(x), True, jcfg)
        return jnp.mean(scores) + sum(jnp.mean(f) for f in feats)

    ref = jax.tree.leaves(jax.grad(loss)(params))
    tp = _torch_tree(params, grad=True)
    scores, feats, _ = tg.disc_apply(tp, _torch_tree(sn), torch.from_numpy(x), True, tcfg)
    got = torch.autograd.grad(scores.mean() + sum(f.mean() for f in feats), tree_leaves(tp))
    # jax.tree.leaves orders dict keys alphabetically; compare by path instead.
    ref_by_path = dict(zip(_paths(params), ref))
    for path, g in zip(_paths(params, sort=False), got):
        want = np.asarray(ref_by_path[path])
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=path)


def _paths(tree, prefix="", sort=True):
    if isinstance(tree, dict):
        keys = sorted(tree) if sort else list(tree)
        return [p for k in keys for p in _paths(tree[k], f"{prefix}/{k}", sort)]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}/{i}", sort)]
    return [prefix]


def test_spectral_normalize_single_and_batched_match_jax():
    rng = np.random.default_rng(10)
    ws = [rng.normal(size=s).astype(np.float32) for s in ((6, 4), (3, 7), (5, 1))]
    us = [(lambda u: u / np.linalg.norm(u))(rng.normal(size=w.shape[1]).astype(np.float32))
          for w in ws]
    for update in (True, False):
        ref_w, ref_u = jlayers.batched_spectral_normalize([jnp.asarray(w) for w in ws],
                                                          [jnp.asarray(u) for u in us], update)
        got_w, got_u = tlayers.batched_spectral_normalize([torch.from_numpy(w) for w in ws],
                                                          [torch.from_numpy(u) for u in us],
                                                          update)
        for a, b in zip(got_w + got_u, ref_w + ref_u):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        w1, u1 = jlayers.spectral_normalize(jnp.asarray(ws[0]), jnp.asarray(us[0]), update)
        t1, v1 = tlayers.spectral_normalize(torch.from_numpy(ws[0]), torch.from_numpy(us[0]),
                                            update)
        np.testing.assert_allclose(t1.numpy(), np.asarray(w1), atol=1e-6)
        np.testing.assert_allclose(v1.numpy(), np.asarray(u1), atol=1e-6)


def test_initializers_have_the_jax_trees_shapes():
    jcfg, tcfg = _configs()
    key = prng.PRNGKey(0)
    pairs = [(jg.encoder_init(jax.random.PRNGKey(0), jcfg), tg.encoder_init(tcfg, key))]
    for temporal in (True, False):
        j, t = _configs(use_temporal_disc=temporal)
        pairs.append((jg.disc_init(jax.random.PRNGKey(0), j), tg.disc_init(t, key)))
    for ref, got in pairs:
        assert _paths(ref) == _paths(got)
        ref_shapes = dict(zip(_paths(ref), [np.shape(a) for a in jax.tree.leaves(ref)]))
        for path, leaf in zip(_paths(got, sort=False), tree_leaves(got)):
            assert tuple(leaf.shape) == ref_shapes[path], path
            assert leaf.dtype == torch.float32
    w = tlayers.conv1d_init(3, 64, 5, key)["w"]
    assert w.shape == (5, 3, 64) and w.abs().max() <= 1 / np.sqrt(15)


def test_conv1d_matches_jax_layout():
    rng = np.random.default_rng(11)
    params = {"w": rng.normal(size=(5, 3, 7)).astype(np.float32),
              "b": rng.normal(size=7).astype(np.float32)}
    x = rng.normal(size=(2, 16, 3)).astype(np.float32)
    ref = jlayers.conv1d(jax.tree.map(jnp.asarray, params), jnp.asarray(x), padding=2)
    got = tlayers.conv1d(_torch_tree(params), torch.from_numpy(x), padding=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_cast_floats_is_a_view_with_float32_gradients():
    w = torch.randn(3, 4, requires_grad=True)
    tree = {"a": [w], "n": torch.arange(3)}
    cast = tlayers.cast_floats(tree, torch.bfloat16)
    assert cast["a"][0].dtype == torch.bfloat16 and cast["n"].dtype == torch.int64
    (g,) = torch.autograd.grad(cast["a"][0].float().sum(), [w])
    assert g.dtype == torch.float32


LOSSES = ["wgan_critic", "wgan_generator", "feature_matching", "reconstruction", "latent",
          "kld", "time_delta", "speed_profile", "time_delta_corr", "mode_seeking",
          "diversity_hinge"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(name):
    rng = np.random.default_rng(12)
    real, fake = _gestures(13, 6), _gestures(14, 6)
    s1, s2 = rng.normal(size=(6, 1)).astype(np.float32), rng.normal(size=(6, 1)).astype(np.float32)
    z1, z2 = rng.normal(size=(6, 4)).astype(np.float32), rng.normal(size=(6, 4)).astype(np.float32)
    feats = [[rng.normal(size=(6, n)).astype(np.float32) for n in (40, 12)] for _ in range(2)]
    args = {
        "wgan_critic": (jl.wgan_critic_loss, tl.wgan_critic_loss, (s1, s2)),
        "wgan_generator": (jl.wgan_generator_loss, tl.wgan_generator_loss, (s1,)),
        "feature_matching": (jl.feature_matching_loss, tl.feature_matching_loss, tuple(feats)),
        "reconstruction": (jl.reconstruction_loss, tl.reconstruction_loss, (real, fake)),
        "latent": (jl.latent_encoding_loss, tl.latent_encoding_loss, (z1, z2)),
        "kld": (jl.kl_divergence_loss, tl.kl_divergence_loss, (z1, z2)),
        "time_delta": (jl.time_delta_loss, tl.time_delta_loss, (real, fake)),
        "speed_profile": (jl.speed_profile_loss, tl.speed_profile_loss, (real, fake)),
        "time_delta_corr": (jl.time_delta_corr_loss, tl.time_delta_corr_loss, (real, fake)),
        "mode_seeking": (jl.mode_seeking_loss, tl.mode_seeking_loss, (real, fake, z1, z2)),
        "diversity_hinge": (lambda a, b: jl.diversity_hinge_loss(a, b, 0.9),
                            lambda a, b: tl.diversity_hinge_loss(a, b, 0.9), (real, fake)),
    }
    jax_fn, torch_fn, arrays = args[name]
    ref = jax_fn(*jax.tree.map(jnp.asarray, arrays))
    got = torch_fn(*tree_map(torch.from_numpy, arrays))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-6)


def test_feature_matching_detaches_real_features():
    real = torch.randn(3, 5, requires_grad=True)
    fake = torch.randn(3, 5, requires_grad=True)
    loss = tl.feature_matching_loss([real.to(torch.bfloat16)], [fake.to(torch.bfloat16)])
    assert loss.dtype == torch.float32
    g_real, g_fake = torch.autograd.grad(loss, [real, fake], allow_unused=True)
    assert g_real is None and g_fake.abs().sum() > 0


@pytest.mark.parametrize("clipped", [True, False])
def test_optimizer_matches_optax(clipped):
    """Global-norm clip then Adam, two steps, against optax."""
    rng = np.random.default_rng(15)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": [rng.normal(size=5).astype(np.float32)]}
    scale = 3.0 if clipped else 0.05
    grads = [tree_map(lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32), params)
             for _ in range(2)]
    tx = make_optimizer(1.0)
    jp, opt = jax.tree.map(jnp.asarray, params), None
    opt = tx.init(jp)
    tp = _torch_tree(params, grad=True)
    topt = adam_init(tree_map(lambda t: t.detach(), tp))
    for g, lr in zip(grads, (2e-4, 1e-4)):
        updates, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, jp)
        jp = jax.tree.map(lambda p, u: p - lr * u, jp, updates)
        apply_update(tp, tree_leaves(tree_map(torch.from_numpy, g)), topt, lr, 1.0)
    norm = np.sqrt(sum(float((a ** 2).sum()) for a in tree_leaves(grads[0])))
    assert (norm > 1.0) == clipped
    adam = opt[-1]
    assert topt["count"] == int(adam.count) == 2
    for got, want in zip(tree_leaves(_numpy(tp)), [jp["a"], jp["b"][0]]):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-7, rtol=1e-6)
    for got, want in zip(tree_leaves(_numpy(topt["mu"])) + tree_leaves(_numpy(topt["nu"])),
                         [adam.mu["a"], adam.mu["b"][0], adam.nu["a"], adam.nu["b"][0]]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-12)


def test_cosine_annealing_lr_matches_jax():
    for step in (0, 1, 17, 100, 200):
        assert cosine_annealing_lr(2e-4, step, 200) == pytest.approx(jax_cosine(2e-4, step, 200))
    assert cosine_annealing_lr(2e-4, 200, 200) == pytest.approx(1e-5)


def test_within_word_diversity_matches_jax():
    g = _gestures(16, 30)
    p = _gestures(17, 30)
    words = [f"w{i % 7}" for i in range(30)]
    ref = jax_within_word_diversity(JaxGestureArrays(g, p, words))
    got = within_word_diversity(GestureArrays(g, p, words))
    assert got == pytest.approx(ref, rel=1e-12)
    ds = GestureArrays(g, p, words)
    assert len(ds) == 30 and ds[3]["word"] == "w3" and ds.word_ids[7] == ds.word_ids[0]
    with pytest.raises(ValueError):
        within_word_diversity(GestureArrays(g[:3], p[:3], ["a", "b", "c"]))


def test_port_configs_carry_the_jax_fields_and_defaults():
    from wordgesture_gan_tpu.configs import TrainingConfig as JaxTrainingConfig
    from wordgesture_gan_tpu_torch.configs import TrainingConfig

    assert dataclasses.asdict(TrainingConfig()) == dataclasses.asdict(JaxTrainingConfig())
    assert dataclasses.asdict(ModelConfig()) == dataclasses.asdict(JaxModelConfig())
