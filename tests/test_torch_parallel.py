"""The port's data parallelism (``wordgesture_gan_tpu_torch/parallel/``) on the
CPU: the environment gate and the row blocks against the JAX package's,
single-process runs that launch no collective, and two gloo ranks in two
processes against one process (the GAN step, the masked step and the
contrastive step, whose SupCon must see a word's two gestures on different
ranks), the contrastive step on two ranks against the JAX package's
single-device step, ``train_cli --data-axis-size 2`` against
``--data-axis-size 1``, and a preemption drill.

Each two-rank check starts ``tests/_torch_parallel_worker.py`` twice, on a
free port, with one thread per worker and a timeout of 120 s each (a hung
collective fails the test). Tolerances, float32: losses 1e-5 relative to
max(1, |loss|); gradients (Adam's moments after a step at lr=0) 1e-5 of the
model's largest; parameters after a step at lr > 0 within 2·lr per Adam
step (Adam's first step maps a near-zero gradient's sign to ±lr); BatchNorm's
running statistics 1e-6. ``train_cli`` across ranks: the JAX two-process
test's tolerances (generator digest rtol 1e-4; losses rtol 5e-3, atol 1e-4).
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_parallel_worker as worker  # noqa: E402

import wordgesture_gan_tpu.parallel.distributed as jax_dist  # noqa: E402
from wordgesture_gan_tpu.configs import ContrastiveConfig as JaxContrastiveConfig  # noqa: E402
from wordgesture_gan_tpu.losses import supervised_contrastive_loss as jax_supcon  # noqa: E402
from wordgesture_gan_tpu.models import contrastive as jax_model  # noqa: E402
from wordgesture_gan_tpu.train import contrastive_loop as jax_loop  # noqa: E402
from wordgesture_gan_tpu.train.state import apply_update as jax_apply_update  # noqa: E402
from wordgesture_gan_tpu_torch.interop.from_jax import (adam_moments,  # noqa: E402
                                                        contrastive_state_from_jax)
from wordgesture_gan_tpu_torch.parallel import distributed as dist_mod  # noqa: E402
from wordgesture_gan_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from wordgesture_gan_tpu_torch.parallel import (create_mesh, distributed_env_requested,  # noqa
                                                maybe_init_distributed,
                                                process_local_batch_slice)
from wordgesture_gan_tpu_torch.utils.preemption import PreemptionGuard  # noqa: E402
from wordgesture_gan_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LOSS_TOL, GRAD_TOL, BN_TOL = 1e-5, 1e-5, 1e-6
SLICES = [(4, 10), (4, 12), (3, 7), (8, 8), (4, 3)]


@pytest.fixture
def clean_env(monkeypatch):
    for var in ("WGG_DISTRIBUTED", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# -- the environment gate and the row blocks -----------------------------------------------


def test_not_requested_by_default(clean_env):
    assert not distributed_env_requested()
    assert maybe_init_distributed("cpu", verbose=False) is False
    assert not torch.distributed.is_initialized()


def test_requested_via_torchrun_vars(clean_env):
    clean_env.setenv("WORLD_SIZE", "4")
    assert distributed_env_requested()


def test_single_process_not_requested(clean_env):
    clean_env.setenv("WORLD_SIZE", "1")
    assert not distributed_env_requested()


def test_requested_via_opt_in(clean_env):
    clean_env.setenv("WGG_DISTRIBUTED", "1")
    assert distributed_env_requested()


def test_single_process_batch_slice(clean_env):
    assert process_local_batch_slice(512) == slice(0, 512) == jax_dist.process_local_batch_slice(512)


@pytest.mark.parametrize("n_proc,global_batch", SLICES)
def test_batch_slices_match_jax(monkeypatch, n_proc, global_batch):
    """The port's row blocks are the JAX package's ceil-division blocks, and
    a ``Mesh`` cuts the same rows, covering each row once."""
    monkeypatch.setattr(jax_dist, "_INITIALIZED", True)
    monkeypatch.setattr(dist_mod, "_INITIALIZED", True)
    monkeypatch.setattr(jax, "process_count", lambda: n_proc)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: n_proc)
    rows = []
    for i in range(n_proc):
        monkeypatch.setattr(jax, "process_index", lambda i=i: i)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None, i=i: i)
        got = process_local_batch_slice(global_batch)
        assert got == jax_dist.process_local_batch_slice(global_batch)
        assert got == mesh_mod.Mesh(world_size=n_proc, rank=i).rows(global_batch)
        rows.extend(range(got.start, got.stop))
    assert rows == list(range(global_batch))


# -- one process: nothing launches --------------------------------------------------------------


def test_single_process_mesh_launches_nothing(clean_env):
    mesh = create_mesh(device="cpu")
    assert not mesh.active and mesh.world_size == 1 and mesh.is_main
    with pytest.raises(ValueError, match="needs that many processes"):
        create_mesh(2)
    tree = {"a": torch.arange(4.0)}
    before = mesh_mod.all_reduce_gradients.launches
    assert mesh_mod.shard_batch(mesh, tree) is tree
    assert mesh_mod.replicate(mesh, tree) is tree
    grads, extra = mesh_mod.all_reduce_gradients(mesh, [tree["a"]], torch.ones(2))
    assert grads[0] is tree["a"] and torch.equal(extra, torch.ones(2))
    x = torch.randn(3, 2, requires_grad=True)
    assert mesh_mod.all_reduce_sum(mesh, x) is x and mesh_mod.all_gather_rows(mesh, x, 3) is x
    assert mesh_mod.all_reduce_gradients.launches == before
    guard = PreemptionGuard()
    assert guard.agreed() is False
    guard.requested = True
    assert guard.agreed(mesh) is True


def test_single_process_training_launches_no_collective(clean_env, tmp_path):
    """``train_gan`` without a distributed environment: no process group, no
    gradient all-reduce, and the throughput counts one chip."""
    from wordgesture_gan_tpu_torch.train.gan_loop import train_gan

    before = mesh_mod.all_reduce_gradients.launches
    mcfg, tcfg = worker.ModelConfig(**dict(worker.MODEL, gen_num_layers=1)), \
        worker.TrainingConfig(batch_size=8, n_critic=1)
    result = train_gan(worker.preempt_dataset(), mcfg, tcfg, num_epochs=1,
                       checkpoint_dir=str(tmp_path), verbose=False, device="cpu")
    assert mesh_mod.all_reduce_gradients.launches == before
    assert not torch.distributed.is_initialized()
    assert result.throughput.n_chips == 1 and result.throughput.items == 32


# -- two gloo ranks against one process -------------------------------------------------------


def run_ranks(mode: str, out_dir: Path, env: dict = None, after_start=None,
              timeout: float = worker.WORKER_TIMEOUT) -> list:
    """Start the worker as two ranks on a free port; return their outputs
    after checking both exited 0."""
    port = dist_mod.free_port()
    procs = []
    for rank in range(2):
        e = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                 **(env or {}))
        procs.append(subprocess.Popen([sys.executable, str(Path(worker.__file__)), mode,
                                       str(out_dir)], env=e, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        if after_start is not None:
            after_start(procs)
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except BaseException:
        for p in procs:
            p.kill()
        raise
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank} OK" in out, out
    return outs


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(1.0, abs(want))


def _compare(got: dict, want: dict, lr: float, adam_steps: dict) -> None:
    for k, v in want["metrics"].items():
        assert _rel(got["metrics"][k], v) <= LOSS_TOL, (lr, k, got["metrics"][k], v)
    for m in (k for k in want if k not in ("metrics", "bn", "collectives")):
        if lr == 0.0:
            for part in ("mu", "nu"):
                scale = max(float(t.abs().max()) for t in want[m][part])
                err = max(float((a - b).abs().max()) for a, b in zip(got[m][part], want[m][part]))
                assert err <= GRAD_TOL * scale, (m, part, err, scale)
        else:
            err = max(float((a - b).abs().max()) for a, b in zip(got[m]["params"],
                                                                  want[m]["params"]))
            assert err <= 2 * lr * adam_steps.get(m, 1), (m, err)
        for a, b in zip(got[m].get("sn", []), want[m].get("sn", [])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    for a, b in zip(got.get("bn", []), want.get("bn", [])):
        assert float((a - b).abs().max()) <= BN_TOL


def _contrastive_init(path: Path, seed: int = 4) -> dict:
    """The JAX package's fresh contrastive state, saved as the port's trees."""
    js = jax.device_get(jax_loop.init_contrastive_state(seed, JaxContrastiveConfig()))
    state = contrastive_state_from_jax(js, "cpu")
    torch.save({"params": tree_map(lambda t: t.detach(), state["params"]), "bn": state["bn"]},
               path)
    return js


@pytest.mark.parametrize("mode", ["gan_step", "masked_step", "contrastive_step"])
def test_two_ranks_match_one_process(mode, tmp_path):
    """Two gloo ranks, each on its half of the global batch, against the
    single-process step on the whole batch from the same state and noise;
    one gradient all-reduce per gradient computation."""
    if mode == "contrastive_step":
        _contrastive_init(tmp_path / "contrastive_init.pt")
    run_ranks(mode, tmp_path)
    got = torch.load(tmp_path / f"{mode}.pt", weights_only=False)
    if mode == "contrastive_step":
        want = worker.run_contrastive_step(None, tmp_path / "contrastive_init.pt")
        collectives, adam_steps = 1, {}
    else:
        want = worker.run_gan_step(None, masked=(mode == "masked_step"))
        n_critic = 2
        collectives, adam_steps = 2 * n_critic + 1, {"d1": n_critic, "d2": n_critic}
    for lr in want:
        assert want[lr]["collectives"] == 0
        assert got[lr]["collectives"] == collectives
        _compare(got[lr], want[lr], lr, adam_steps)


def test_two_rank_contrastive_step_matches_jax(tmp_path):
    """The two-rank SupCon step (a word's gestures split across the ranks)
    against the JAX package's single-device step from the same state: the
    loss, Adam's moments at lr=0, the parameters after a step at lr=1e-3 and
    BatchNorm's running statistics, as tests/test_torch_contrastive.py holds
    the single-process step."""
    js = _contrastive_init(tmp_path / "contrastive_init.pt")
    run_ranks("contrastive_step", tmp_path)
    got = torch.load(tmp_path / "contrastive_step.pt", weights_only=False)
    batch, labels = worker.contrastive_setup()
    tx = jax_loop.make_contrastive_optimizer()

    for lr in (0.0, worker.CONTRASTIVE_LR):
        def loss_fn(p):
            emb, new_bn = jax_model.contrastive_encoder_apply(p, js["bn"],
                                                              jnp.asarray(batch.numpy()),
                                                              train=True)
            return jax_supcon(emb, jnp.asarray(labels.numpy()), 0.07), new_bn

        (loss, new_bn), g = jax.value_and_grad(loss_fn, has_aux=True)(js["params"])
        new_p, new_opt = jax_apply_update(js["params"], g, js["opt"], tx, lr)
        new_p, new_opt, new_bn, g = jax.device_get((new_p, new_opt, new_bn, g))
        run = got[lr]
        assert run["metrics"]["loss"] == pytest.approx(float(loss), rel=1e-5)
        g_scale = max(float(np.abs(x).max()) for x in jax.tree.leaves(g))
        if lr == 0.0:
            mu = adam_moments(new_opt)["mu"]
            scale = max(float(np.abs(x).max()) for x in jax.tree.leaves(mu))
            for a, b in zip(run["c"]["mu"], jax.tree.leaves(mu)):
                assert float(np.abs(a.numpy() - b).max()) <= GRAD_TOL * scale
        else:
            for a, b, gl in zip(run["c"]["params"], jax.tree.leaves(new_p), jax.tree.leaves(g)):
                near_zero = np.abs(gl) < 1e-4 * g_scale
                assert (np.abs(a.numpy() - b) <= 1e-5 + 2 * lr * near_zero).all()
        for a, b in zip(run["bn"], jax.tree.leaves(new_bn)):
            np.testing.assert_allclose(a.numpy(), b, atol=BN_TOL)


# -- the CLI across ranks, and the preemption drill --------------------------------------------

CLI_ARGS = ["--epochs", "2", "--synthetic", "--synthetic-users", "4", "--device", "cpu",
            "--gen-hidden", "8", "--batch-size", "60", "--precision", "float32"]


def _train_cli(data: Path, ckpt: Path, axis: int) -> str:
    out = subprocess.run([sys.executable, "-m", "wordgesture_gan_tpu_torch.train_cli", *CLI_ARGS,
                          "--data", str(data / "swipelogs.zip"), "--checkpoint-dir", str(ckpt),
                          "--data-axis-size", str(axis)], cwd=REPO, capture_output=True,
                         text=True, timeout=worker.WORKER_TIMEOUT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def _digest(ckpt: Path) -> float:
    state = torch.load(ckpt / "latest.pt", map_location="cpu", weights_only=True)
    return float(sum(t.abs().sum() for t in tree_leaves(state["g"]["params"])))


def _history(ckpt: Path) -> list:
    return [json.loads(line) for line in (ckpt / "history.jsonl").read_text().splitlines()]


def test_train_cli_two_ranks_match_one(tmp_path):
    """``train_cli --device cpu --data-axis-size 2`` starts a second rank
    itself and trains to the history and generator of ``--data-axis-size
    1``; rank 0 alone logs and writes. At batch 60 (2 steps an epoch, 20
    critic updates in all): Adam turns last-bit differences in near-zero
    gradients into ±lr moves, and over more updates the critics' scores
    drift past the tolerances, as they would between any two summation
    orders."""
    one = _train_cli(tmp_path, tmp_path / "one", 1)
    two = _train_cli(tmp_path, tmp_path / "two", 2)
    assert "Distributed: 2 rank(s) over gloo" in two and "Distributed" not in one
    assert len(re.findall(r"^Epoch 1/2", two, re.M)) == 1       # one rank logs
    want, got = _history(tmp_path / "one"), _history(tmp_path / "two")
    assert len(got) == len(want) == 2
    for k, v in want[-1].items():
        np.testing.assert_allclose(got[-1][k], v, rtol=5e-3, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(_digest(tmp_path / "two"), _digest(tmp_path / "one"), rtol=1e-4)
    assert sorted(p.name for p in (tmp_path / "two").glob("epoch_*.pt")) == ["epoch_2.pt"]


def test_two_rank_preemption_drill(tmp_path):
    """SIGTERM one of two training ranks mid-run: ``PreemptionGuard.agreed()``
    stops both on the same epoch with a checkpoint, and a rerun resumes and
    finishes the remaining epochs."""
    marker = tmp_path / "underway"

    def sigterm_rank_1(procs):
        deadline = time.time() + worker.WORKER_TIMEOUT
        while not marker.exists():
            assert all(p.poll() is None for p in procs), "a rank exited before the drill"
            assert time.time() < deadline, "training never got under way"
            time.sleep(0.05)
        procs[1].send_signal(signal.SIGTERM)

    outs = run_ranks("preempt", tmp_path, after_start=sigterm_rank_1)
    phase1, phase2 = {}, {}
    for out in outs:
        for m in re.finditer(r"PHASE1 rank=(\d) epochs=(\d+) state_epoch=(\d+)", out):
            phase1[int(m.group(1))] = (int(m.group(2)), int(m.group(3)))
        for m in re.finditer(r"PHASE2 rank=(\d) epochs=(\d+)", out):
            phase2[int(m.group(1))] = int(m.group(2))
    assert set(phase1) == {0, 1}, outs
    assert phase1[0] == phase1[1], phase1          # the same epoch on both ranks
    assert 1 < phase1[0][0] < 400
    stopped = phase1[0][1]
    saved = torch.load(tmp_path / "ckpt" / f"epoch_{stopped}.pt", weights_only=True)
    assert saved["epoch"] == stopped
    assert phase2 == {0: 3, 1: 3}, outs
    assert torch.load(tmp_path / "ckpt" / "latest.pt", weights_only=True)["epoch"] == stopped + 3
