"""One rank of the port's two-rank data-parallel checks (tests/test_torch_parallel.py).

    python tests/_torch_parallel_worker.py MODE OUT_DIR

Started twice by the test with torchrun's variables (WORLD_SIZE=2, RANK,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT); each rank joins the gloo process group
through ``parallel.maybe_init_distributed`` on the CPU, runs MODE and, on rank
0, writes what it computed to OUT_DIR/<MODE>.pt for the test to hold against
the single-process run of the same function. Modes:

  gan_step         one ``gan_train_step`` at lr=0 and one at LR from the same state;
  masked_step      the same for ``gan_train_step_masked``;
  contrastive_step one ``contrastive_train_step`` at lr=0 and one at CONTRASTIVE_LR,
                   from the state in OUT_DIR/contrastive_init.pt;
  preempt          ``train_gan`` for many epochs with checkpoints, until the test
                   signals one rank; then a rerun of the same call that resumes.

The set-up functions (``gan_setup``, ``masked_setup``, ``contrastive_setup``) are
imported by the test too, so both sides start from the same state and data.
The module imports no JAX.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import numpy as np
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu_torch.configs import ModelConfig, TrainingConfig
from wordgesture_gan_tpu_torch.utils.tree import tree_leaves

B, L, Z, LR = 8, 16, 4, 2e-4
MODEL = dict(seq_length=L, gen_hidden_dim=8, gen_num_layers=2, latent_dim=Z,
             enc_hidden_dims=(24, 16), time_head="monotone")
FLAGSHIP = dict(batch_size=B, n_critic=2, lambda_speed=2.0, lambda_div=0.3, lambda_dtc=4.0,
                div_margin=0.25)
MASKED_MODEL = dict(generator_type="transformer", tfm_d_model=16, tfm_num_heads=2,
                    tfm_num_layers=1, seq_length=L, latent_dim=Z, enc_hidden_dims=(24, 16),
                    time_head="monotone")
CONTRASTIVE_WORDS, CONTRASTIVE_SEQ, CONTRASTIVE_LR = 8, 32, 1e-3
WORKER_TIMEOUT = 120


def gan_setup(seed: int = 0):
    """(ModelConfig, TrainingConfig, batch, noise) of the GAN step checks: B=8
    gestures with a monotone clock, the flagship recipe at n_critic 2."""
    rng = np.random.default_rng(seed)
    gesture = rng.uniform(-1, 1, (B, L, 3)).astype(np.float32)
    gesture[..., 2] = np.sort(rng.uniform(0, 1, (B, L)), axis=1)
    batch = {"gesture": gesture, "prototype": rng.uniform(-1, 1, (B, L, 3)).astype(np.float32)}
    n_c = FLAGSHIP["n_critic"]
    noise = {"z_rand": rng.normal(size=(n_c, B, Z)), "eps_enc": rng.normal(size=(n_c, B, Z)),
             "z1": rng.normal(size=(B, Z)), "eps_rec": rng.normal(size=(B, Z)),
             "eps2": rng.normal(size=(B, Z)), "z_ms": rng.normal(size=(B, Z))}
    return (ModelConfig(**MODEL), TrainingConfig(**FLAGSHIP),
            {k: torch.from_numpy(v) for k, v in batch.items()},
            {k: torch.from_numpy(v.astype(np.float32)) for k, v in noise.items()})


def masked_setup(seed: int = 1):
    """The masked step's: B=8 traces of lengths 5..16 (uneven valid-point
    counts per rank), the reference recipe with the timing auxiliaries."""
    rng = np.random.default_rng(seed)
    lengths = np.array([16, 5, 9, 16, 7, 12, 16, 6])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    gesture = rng.uniform(-1, 1, (B, L, 3)).astype(np.float32)
    gesture[..., 2] = np.sort(rng.uniform(0, 1, (B, L)), axis=1)
    batch = {"gesture": gesture * mask[..., None],
             "prototype": (rng.uniform(-1, 1, (B, L, 3)) * mask[..., None]).astype(np.float32),
             "mask": mask}
    noise = {"z_rand": rng.normal(size=(2, B, Z)), "eps_enc": rng.normal(size=(2, B, Z)),
             "z1": rng.normal(size=(B, Z)), "eps_rec": rng.normal(size=(B, Z)),
             "eps2": rng.normal(size=(B, Z))}
    tcfg = TrainingConfig(batch_size=B, n_critic=2, lambda_dt=1.0, lambda_speed=2.0,
                          lambda_dtc=4.0)
    return (ModelConfig(**MASKED_MODEL), tcfg,
            {k: torch.from_numpy(v) for k, v in batch.items()},
            {k: torch.from_numpy(v.astype(np.float32)) for k, v in noise.items()})


def contrastive_setup(seed: int = 2):
    """(batch, labels) of 8 words x 2 gestures at L=32, ordered so that every
    word's first gesture is in the first half of the batch and its second in
    the second half: on two ranks, no word has both gestures on one rank."""
    from wordgesture_gan_tpu_torch.keyboard import QWERTYKeyboard

    kb = QWERTYKeyboard()
    rng = np.random.default_rng(seed)
    words = ["hello", "world", "water", "thing", "sound", "point", "house", "light"]
    base = np.stack([kb.get_minimum_jerk_trajectory(w, CONTRASTIVE_SEQ) for w in words])
    batch = np.concatenate([base + rng.normal(0, 0.02, base.shape) for _ in range(2)])
    labels = np.tile(np.arange(CONTRASTIVE_WORDS), 2)
    return torch.from_numpy(batch.astype(np.float32)), torch.from_numpy(labels).long()


def contrastive_state(path: Path):
    """A fresh CPU contrastive state from the {"params", "bn"} trees saved at ``path``."""
    from wordgesture_gan_tpu_torch.train.contrastive_loop import make_contrastive_state

    init = torch.load(path, weights_only=True)
    return make_contrastive_state(init["params"], init["bn"], "cpu")


def snapshot(state, metrics=None) -> dict:
    """The parts of a GAN or contrastive state the checks compare, on the CPU."""
    out = {"metrics": {k: float(v) for k, v in (metrics or {}).items()}}
    models = ("g", "e", "d1", "d2") if "g" in state else (None,)
    for m in models:
        s = state if m is None else state[m]
        key = m or "c"
        out[key] = {"params": [p.detach().clone() for p in tree_leaves(s["params"])],
                    "mu": [t.clone() for t in tree_leaves(s["opt"]["mu"])],
                    "nu": [t.clone() for t in tree_leaves(s["opt"]["nu"])]}
        if "sn" in s:
            out[key]["sn"] = [t.clone() for t in tree_leaves(s["sn"])]
    if "bn" in state:
        out["bn"] = [t.clone() for t in tree_leaves(state["bn"])]
    return out


def run_gan_step(mesh, masked: bool) -> dict:
    """Both steps' snapshots, with the gradient all-reduces each step made."""
    from wordgesture_gan_tpu_torch.parallel.mesh import all_reduce_gradients
    from wordgesture_gan_tpu_torch.train.gan_step import gan_train_step
    from wordgesture_gan_tpu_torch.train.masked_step import gan_train_step_masked
    from wordgesture_gan_tpu_torch.train.state import init_gan_state

    mcfg, tcfg, batch, noise = masked_setup() if masked else gan_setup()
    step = gan_train_step_masked if masked else gan_train_step
    out = {}
    for lr in (0.0, LR):
        state = init_gan_state(0, mcfg, "cpu")
        before = all_reduce_gradients.launches
        _, metrics = step(state, batch, lr, mcfg, tcfg, noise=noise, mesh=mesh)
        out[lr] = snapshot(state, metrics)
        out[lr]["collectives"] = all_reduce_gradients.launches - before
    return out


def run_contrastive_step(mesh, init: Path) -> dict:
    from wordgesture_gan_tpu_torch.parallel.mesh import all_reduce_gradients
    from wordgesture_gan_tpu_torch.train.contrastive_loop import contrastive_train_step

    batch, labels = contrastive_setup()
    out = {}
    for lr in (0.0, CONTRASTIVE_LR):
        state = contrastive_state(init)
        before = all_reduce_gradients.launches
        loss = contrastive_train_step(state, batch, labels, lr, mesh=mesh)
        out[lr] = snapshot(state, {"loss": loss})
        out[lr]["collectives"] = all_reduce_gradients.launches - before
    return out


def preempt_dataset():
    from wordgesture_gan_tpu_torch.data.pipeline import GestureArrays

    rng = np.random.default_rng(0)
    n = 32
    g = np.clip(rng.normal(0, 0.4, size=(n, L, 3)), -1, 1).astype(np.float32)
    p = np.clip(rng.normal(0, 0.4, size=(n, L, 3)), -1, 1).astype(np.float32)
    g[:, :, 2] = p[:, :, 2] = np.linspace(0.0, 1.0, L, dtype=np.float32)
    return GestureArrays(g, p, [f"w{i % 8}" for i in range(n)])


def run_preempt(out_dir: Path, rank: int) -> None:
    """Train until the test's signal stops both ranks on one epoch, then
    rerun to the end. The marker file tells the test training is under way."""
    from wordgesture_gan_tpu_torch.configs import RuntimeConfig
    from wordgesture_gan_tpu_torch.train.gan_loop import train_gan

    mcfg = ModelConfig(**dict(MODEL, gen_num_layers=1, gen_hidden_dim=4))
    tcfg = TrainingConfig(batch_size=B, n_critic=1, save_every=1000)
    ckpt = out_dir / "ckpt"
    total = 400

    def mark(epoch, state, losses):
        if epoch == 1:
            (out_dir / "underway").touch()

    first = train_gan(preempt_dataset(), mcfg, tcfg, RuntimeConfig(data_axis_size=2),
                      num_epochs=total, seed=3, checkpoint_dir=str(ckpt), verbose=False,
                      epoch_callback=mark, device="cpu")
    print(f"PHASE1 rank={rank} epochs={len(first.history)} state_epoch={first.state['epoch']}",
          flush=True)
    second = train_gan(preempt_dataset(), mcfg, tcfg, RuntimeConfig(data_axis_size=2),
                       num_epochs=first.state["epoch"] + 3, seed=3, checkpoint_dir=str(ckpt),
                       verbose=False, device="cpu")
    print(f"PHASE2 rank={rank} epochs={len(second.history)} "
          f"state_epoch={second.state['epoch']}", flush=True)


def main() -> int:
    from wordgesture_gan_tpu_torch.parallel import (create_mesh, maybe_init_distributed,
                                                    shutdown_distributed)

    mode, out_dir = sys.argv[1], Path(sys.argv[2])
    assert maybe_init_distributed("cpu", verbose=False, timeout=WORKER_TIMEOUT)
    mesh = create_mesh(2, device="cpu")
    rank = mesh.rank
    try:
        if mode == "preempt":
            run_preempt(out_dir, rank)
        else:
            result = {"gan_step": lambda: run_gan_step(mesh, masked=False),
                      "masked_step": lambda: run_gan_step(mesh, masked=True),
                      "contrastive_step": lambda: run_contrastive_step(
                          mesh, out_dir / "contrastive_init.pt")}[mode]()
            if rank == 0:
                torch.save(result, out_dir / f"{mode}.pt")
    finally:
        shutdown_distributed()
    print(f"rank {rank} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
