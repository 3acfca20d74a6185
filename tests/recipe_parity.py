"""Test data and a tree flattener shared by the recipe parity tests
(``test_torch_recipe_step.py``, ``test_torch_recipe_trajectory.py``)."""

import numpy as np

from wordgesture_gan_tpu_torch.keyboard import QWERTYKeyboard

STEP_B = 4
WORDS = ["the", "quick", "brown", "keyboard"]


def gesture_batch(seq: int, masked: bool) -> dict:
    """Keyboard prototypes of WORDS, the gestures a smooth wobble off them
    with a warped monotone clock; masked: true lengths 128, 97, 64, 40, the
    padding repeating the last valid point."""
    rng = np.random.default_rng(11)
    kb = QWERTYKeyboard()
    protos = np.stack([kb.get_word_prototype(w, seq) for w in WORDS]).astype(np.float32)
    u = np.linspace(0, 1, seq)[None, :, None]
    g = protos.copy()
    g[..., :2] = np.clip(protos[..., :2] + 0.05 * np.sin(
        2 * np.pi * rng.uniform(0.5, 2, (STEP_B, 1, 2)) * u + rng.uniform(0, 6, (STEP_B, 1, 2))),
        -1, 1)
    clock = np.cumsum(rng.uniform(0.5, 1.5, (STEP_B, seq)), axis=1)
    g[..., 2] = (clock - clock[:, :1]) / (clock[:, -1:] - clock[:, :1])
    batch = {"gesture": g.astype(np.float32), "prototype": protos}
    if masked:
        lengths = np.array([seq, 97, 64, 40])
        batch["mask"] = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.float32)
        for arr in (batch["gesture"], batch["prototype"]):
            for i, n in enumerate(lengths):
                arr[i, n:] = arr[i, n - 1]
    return batch


def leaves_by_path(tree, prefix=""):
    """A tree of dicts, lists and tuples as {"/key/0/...": leaf}."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in leaves_by_path(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree)
                for p, v in leaves_by_path(x, f"{prefix}/{i}").items()}
    return {prefix: tree}
