"""The plain reference of one two-cycle WGAN train step (BicycleGAN cycles,
n_critic critic updates, then one joint generator and encoder update), of
its fixed-length and masked (variable-length) forms, and of everything the
step is fed: the initial weights drawn from the seed, the epoch's shuffle,
the key chain and the noise, the diversity margin measured from the data.

It follows the published recipe and the JAX key tree the program also
follows, in float32 (or with float8 products, ``models.Precision``), from
the seed and the benchmark's own corpus alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import prng
from .models import FLOAT32, Precision, critic, encoder, exact_products, generator

ADAM_B1, ADAM_B2, ADAM_EPS = 0.5, 0.999, 1e-8
MODELS = ("g", "e", "d1", "d2")
CONVS = ((3, 64, 5), (64, 64, 5), (64, 32, 3))   # in, out, kernel


# -- initial weights (PyTorch's default initializers, drawn from JAX keys) ---------------


def _uniform(key, shape, bound: float) -> torch.Tensor:
    return prng.uniform(key, shape, -bound, bound)


def dense_init(i: int, o: int, key) -> Dict[str, torch.Tensor]:
    kw, kb = prng.split(key)
    b = 1.0 / math.sqrt(i)
    return {"w": _uniform(kw, (i, o), b), "b": _uniform(kb, (o,), b)}


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + 1e-12)


def _sn_dense_init(i: int, o: int, key):
    kp, ku = prng.split(key)
    return dense_init(i, o, kp), _unit(prng.normal(ku, (o,)))


def generator_init(model: Dict, key) -> Dict:
    Z = model["latent_dim"]
    if model["generator_type"] == "bilstm":
        H = model["gen_hidden_dim"]
        k_lstm, k_out = prng.split(key)
        layers, d, k = [], 2 + Z, k_lstm
        for _ in range(model["gen_num_layers"]):
            kf, kb, k = prng.split(k, 3)
            layer = {}
            for name, kc in (("fwd", kf), ("bwd", kb)):
                k1, k2, k3, k4 = prng.split(kc, 4)
                b = 1.0 / math.sqrt(H)
                layer[name] = {"w_ih": _uniform(k1, (d, 4 * H), b),
                               "w_hh": _uniform(k2, (H, 4 * H), b),
                               "b_ih": _uniform(k3, (4 * H,), b),
                               "b_hh": _uniform(k4, (4 * H,), b)}
            layers.append(layer)
            d = 2 * H
        return {"lstm": layers, "out": dense_init(2 * H, 3, k_out)}
    if model["generator_type"] == "transformer":
        D, n = model["tfm_d_model"], model["tfm_num_layers"]
        keys = prng.split(key, n + 3)
        blocks = []
        for i in range(n):
            k = prng.split(keys[2 + i], 6)
            m = model["tfm_mlp_ratio"] * D
            blocks.append({"ln1": _ln(D), "qkv": dense_init(D, 3 * D, k[0]),
                           "attn_out": dense_init(D, D, k[1]), "ln2": _ln(D),
                           "mlp1": dense_init(D, m, k[2]), "mlp2": dense_init(m, D, k[3])})
        return {"embed": dense_init(2 + Z, D, keys[0]),
                "pos": prng.normal(keys[1], (model["seq_length"], D)) * 0.02,
                "blocks": blocks, "ln_f": _ln(D), "out": dense_init(D, 3, keys[-1])}
    raise ValueError(f"no reference for generator {model['generator_type']!r}")


def _ln(d: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def encoder_init(model: Dict, key) -> Dict:
    dims = (model["seq_length"] * 3,) + tuple(model["enc_hidden_dims"])
    keys = prng.split(key, len(dims) + 1)
    return {"mlp": [dense_init(dims[i], dims[i + 1], keys[i]) for i in range(len(dims) - 1)],
            "mu": dense_init(dims[-1], model["latent_dim"], keys[-2]),
            "log_var": dense_init(dims[-1], model["latent_dim"], keys[-1])}


def critic_init(key) -> Tuple[Dict, Dict]:
    keys = prng.split(key, 6)
    convs, us = [], []
    for (cin, cout, k), kc in zip(CONVS, keys[:3]):
        kp, ku = prng.split(kc)
        kw, kb = prng.split(kp)
        b = 1.0 / math.sqrt(cin * k)
        convs.append({"w": _uniform(kw, (k, cin, cout), b), "b": _uniform(kb, (cout,), b)})
        us.append(_unit(prng.normal(ku, (cout,))))
    m1, u1 = _sn_dense_init(CONVS[-1][1] * 8, 128, keys[3])
    m2, u2 = _sn_dense_init(128, 64, keys[4])
    out, uo = _sn_dense_init(64, 1, keys[5])
    return {"convs": convs, "mlp": [m1, m2], "out": out}, {"convs": us, "mlp": [u1, u2], "out": uo}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: tensor} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def init_state(seed: int, model: Dict, device) -> Dict:
    """The initial train state of the seed: PRNGKey(seed) split into the
    keys of G, E, D1, D2 and the state's own key."""
    kg, ke, kd1, kd2, krng = prng.split(prng.PRNGKey(seed), 5)
    d1, u1 = critic_init(kd1)
    d2, u2 = critic_init(kd2)
    params = {"g": generator_init(model, kg), "e": encoder_init(model, ke), "d1": d1, "d2": d2}
    state = {}
    for m in MODELS:
        p = _map(lambda t: t.to(device).requires_grad_(True), params[m])
        state[m] = {"params": p,
                    "opt": {"mu": _map(lambda t: torch.zeros_like(t.detach()), p),
                            "nu": _map(lambda t: torch.zeros_like(t.detach()), p), "count": 0}}
    state["d1"]["sn"] = _map(lambda t: t.to(device), u1)
    state["d2"]["sn"] = _map(lambda t: t.to(device), u2)
    state["rng"] = krng
    return state


# -- what the step is fed -------------------------------------------------------------------


def within_word_diversity(gestures: np.ndarray, words: List[str], max_pairs: int = 4,
                          seed: int = 0) -> float:
    """Mean L1 between two gestures of one word, up to ``max_pairs`` pairs a
    word, words in order of first appearance: the diversity hinge's margin."""
    vocab: Dict[str, int] = {}
    ids = np.array([vocab.setdefault(w, len(vocab)) for w in words], np.int32)
    rng = np.random.default_rng(seed)
    order = np.argsort(ids, kind="stable")
    groups = np.split(order, np.flatnonzero(np.diff(ids[order])) + 1)
    dists = []
    for idx in groups:
        n = len(idx)
        if n < 2:
            continue
        for _ in range(min(max_pairs, n * (n - 1) // 2)):
            i, j = rng.choice(n, size=2, replace=False)
            dists.append(float(np.abs(gestures[idx[i]] - gestures[idx[j]]).mean()))
    return float(np.mean(dists))


def epoch_rows(seed: int, epoch: int, n: int) -> np.ndarray:
    """The corpus rows of an epoch in batch order: the permutation of
    fold_in(PRNGKey(seed ^ 0x5EED), epoch)."""
    return prng.permutation(prng.fold_in(prng.PRNGKey(seed ^ 0x5EED), epoch), n)


def step_keys(rng, n_critic: int, diversity: bool):
    """(advanced key, the step's draw keys): per critic update (rng, kz, ke);
    then (rng, kz1, ke1, ke2); with the diversity terms (rng, kz_ms)."""
    kz, ke = [], []
    for _ in range(n_critic):
        rng, z, e = prng.split(rng, 3)
        kz.append(z)
        ke.append(e)
    rng, kz1, ke1, ke2 = prng.split(rng, 4)
    keys = kz + ke + [kz1, ke1, ke2]
    if diversity:
        rng, kz_ms = prng.split(rng)
        keys.append(kz_ms)
    return rng, keys


def step_noise(keys, batch: int, latent: int, n_critic: int, device) -> Dict[str, torch.Tensor]:
    draws = torch.stack([prng.normal(k, (batch, latent)) for k in keys]).to(device)
    out = {"z_rand": draws[:n_critic], "eps_enc": draws[n_critic:2 * n_critic]}
    for i, name in enumerate(("z1", "eps_rec", "eps2", "z_ms")[:len(keys) - 2 * n_critic]):
        out[name] = draws[2 * n_critic + i]
    return out


# -- losses ---------------------------------------------------------------------------------


def _fm(real: List[torch.Tensor], fake: List[torch.Tensor]) -> torch.Tensor:
    total = 0.0
    for r, f in zip(real, fake):
        total = total + (f - r.detach()).abs().mean() / (r.numel() // r.shape[0])
    return total / len(real)


def _kld(mu, log_var):
    return (-0.5 * (1 + log_var - mu * mu - torch.exp(log_var)).sum(dim=1)).mean()


def _pearson(a, b, w, eps):
    if w is None:
        am, bm = a - a.mean(1, keepdim=True), b - b.mean(1, keepdim=True)
    else:
        n = torch.clamp(w.sum(1, keepdim=True), min=1.0)
        am = (a - (a * w).sum(1, keepdim=True) / n) * w
        bm = (b - (b * w).sum(1, keepdim=True) / n) * w
    return (am * bm).sum(1) / torch.sqrt((am * am).sum(1) * (bm * bm).sum(1) + eps)


def _speeds(g):
    d = torch.diff(g[:, :, :2], dim=1)
    return torch.sqrt((d * d).sum(-1) + 1e-12) / torch.clamp(torch.diff(g[:, :, 2], dim=1),
                                                             min=1e-4)


def speed_loss(real, fake, mask=None):
    w = None if mask is None else mask[:, 1:] * mask[:, :-1]
    return (1.0 - _pearson(_speeds(real), _speeds(fake), w, 1e-8)).mean()


def dt_corr_loss(real, fake, mask=None):
    w = None if mask is None else mask[:, 1:] * mask[:, :-1]
    return (1.0 - _pearson(torch.diff(real[:, :, 2], dim=1), torch.diff(fake[:, :, 2], dim=1),
                           w, 1e-12)).mean()


# -- the optimizer ------------------------------------------------------------------------


@torch.no_grad()
def adam(params, grads: List[torch.Tensor], opt: Dict, lr: float, clip: float) -> None:
    """Global-norm clipping (scale max/‖g‖ when ‖g‖ >= max), then Adam with
    bias correction, β = (0.5, 0.999), ε outside the square root."""
    p = list(leaves(params).values())
    mu, nu = list(leaves(opt["mu"]).values()), list(leaves(opt["nu"]).values())
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = 1.0 if norm < clip else clip / norm
    opt["count"] += 1
    c1, c2 = 1.0 - ADAM_B1 ** opt["count"], 1.0 - ADAM_B2 ** opt["count"]
    for pi, gi, mi, vi in zip(p, grads, mu, nu):
        gi = gi * scale
        mi.mul_(ADAM_B1).add_(gi, alpha=1.0 - ADAM_B1)
        vi.mul_(ADAM_B2).addcmul_(gi, gi, value=1.0 - ADAM_B2)
        pi.sub_(lr * (mi / c1) / (torch.sqrt(vi / c2) + ADAM_EPS))


# -- the step --------------------------------------------------------------------------------


def _critic_update(d: Dict, real, fake, lr: float, clip: float, P: Precision) -> torch.Tensor:
    real_s, _, us = critic(d["params"], d["sn"], real, P)
    fake_s, _, us = critic(d["params"], us, fake.detach(), P)
    loss = fake_s.mean() - real_s.mean()
    grads = torch.autograd.grad(loss, list(leaves(d["params"]).values()))
    adam(d["params"], list(grads), d["opt"], lr, clip)
    d["sn"] = us
    return loss.detach()


def train_step(state: Dict, batch: Dict[str, torch.Tensor], noise: Dict[str, torch.Tensor],
               lr: float, model: Dict, training: Dict, P: Precision = FLOAT32,
               margin: Optional[float] = None) -> Dict[str, float]:
    """One two-cycle step on ``batch`` ("gesture", "prototype" (B, L, 3); with
    "mask" (B, L) the masked form: outputs zeroed on the padding, the real
    traces' padding zeroed, reconstruction and timing over valid points
    only, no diversity terms). Updates ``state`` in place; returns the
    step's losses by the program's metric names."""
    tc = training
    if tc.get("lambda_dt") or tc.get("lambda_ms") or tc.get("fused_critic_forward"):
        raise ValueError("the reference has no time-delta, mode-seeking or fused-critic terms")
    if not model.get("use_temporal_disc", True) or model.get("prototype_has_time"):
        raise ValueError("the reference has the temporal critic and xy prototypes only")
    real, proto = batch["gesture"], batch["prototype"]
    mask = batch.get("mask")
    b = real.shape[0]
    g, e, d1, d2 = (state[m] for m in MODELS)

    def gen(prototype, z, m):
        out = generator(g["params"], prototype, z, model, P, pad_mask=m)
        return out if m is None else out * m[:, :, None]

    real_in = real if mask is None else real * mask[:, :, None]
    n_c = tc["n_critic"]
    with exact_products():
        with torch.no_grad():
            _, mu_c, lv_c = encoder(e["params"], real_in, noise["eps_enc"][0], P)
            z_encs = mu_c[None] + noise["eps_enc"] * torch.exp(0.5 * lv_c)[None]
        proto2 = torch.cat([proto, proto])
        mask2 = None if mask is None else torch.cat([mask, mask])
        for i in range(n_c):
            with torch.no_grad():
                fakes = gen(proto2, torch.cat([noise["z_rand"][i], z_encs[i]]), mask2)
            d1_loss = _critic_update(d1, real_in, fakes[:b], lr, tc["grad_clip_norm"], P)
            d2_loss = _critic_update(d2, real_in, fakes[b:], lr, tc["grad_clip_norm"], P)

        z = noise["z1"]
        fake1 = gen(proto, z, mask)
        f1_s, f1_f, us1 = critic(d1["params"], d1["sn"], fake1, P)
        with torch.no_grad():
            _, r1_f, us1 = critic(d1["params"], us1, real_in, P)
            z_rec, _, _ = encoder(e["params"], fake1.detach(), noise["eps_rec"], P)
        c1 = (-f1_s.mean() + tc["lambda_feat"] * _fm(r1_f, f1_f)
              + tc["lambda_lat"] * (z_rec - z).abs().mean())
        if mask is None and tc.get("lambda_div"):
            fake_ms = gen(proto, noise["z_ms"], None)
            dist = (fake1 - fake_ms).abs().mean(dim=(1, 2))
            c1 = c1 + tc["lambda_div"] * (torch.relu(margin - dist) / margin).mean()

        z_enc, mu, log_var = encoder(e["params"], real_in, noise["eps2"], P)
        fake2 = gen(proto, z_enc, mask)
        f2_s, f2_f, us2 = critic(d2["params"], d2["sn"], fake2, P)
        with torch.no_grad():
            _, r2_f, us2 = critic(d2["params"], us2, real_in, P)
        if mask is None:
            rec = (fake2 - real).abs().mean()
        else:
            rec = ((fake2 - real).abs() * mask[:, :, None]).sum() / torch.clamp(
                mask.sum() * real.shape[-1], min=1.0)
        c2 = (-f2_s.mean() + tc["lambda_feat"] * _fm(r2_f, f2_f) + tc["lambda_rec"] * rec
              + tc["lambda_kld"] * _kld(mu, log_var))
        if tc.get("lambda_speed"):
            c2 = c2 + tc["lambda_speed"] * speed_loss(real, fake2, mask)
        if tc.get("lambda_dtc"):
            c2 = c2 + tc["lambda_dtc"] * dt_corr_loss(real, fake2, mask)

        g_leaves = list(leaves(g["params"]).values())
        e_leaves = list(leaves(e["params"]).values())
        grads = torch.autograd.grad(c1 + c2, g_leaves + e_leaves)
        adam(g["params"], list(grads[:len(g_leaves)]), g["opt"], lr, tc["grad_clip_norm"])
        adam(e["params"], list(grads[len(g_leaves):]), e["opt"], lr, tc["grad_clip_norm"])
        d1["sn"], d2["sn"] = us1, us2
    return {"d1_loss": float(d1_loss), "d2_loss": float(d2_loss), "cycle1_total": c1.item(),
            "cycle2_total": c2.item(), "cycle2_rec": rec.item()}
