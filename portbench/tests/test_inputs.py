"""The generators of the inputs: job sizes and lengths against their
stated ranges and means, the same work for every seed."""

import numpy as np
import pytest

from portbench import corpus
from portbench.kinds import generate


def test_job_sizes_log_uniform_same_set_every_seed():
    spec = {"min": 256, "max": 16384, "count": 64}
    a = generate.job_plan(spec, np.random.default_rng(1), 640)
    b = generate.job_plan(spec, np.random.default_rng(2), 640)
    assert min(a) >= 256 and max(a) <= 16384
    assert sorted(a) == sorted(b) and a != b
    # The mean of log-uniform(256, 16384) is (16384 - 256) / ln 64 = 3878.
    assert np.mean(a) == pytest.approx((16384 - 256) / np.log(64), rel=0.02)
    assert np.median(a) == pytest.approx(2048, rel=0.05)


def test_lengths_match_the_variable_length_corpus():
    dist = {"min": 12, "max": 128, "full_share": 0.836}
    a = corpus.lengths(20331, dist, np.random.default_rng(3))
    b = corpus.lengths(20331, dist, np.random.default_rng(4))
    assert a.min() == 12 and a.max() == 128
    assert a.mean() == pytest.approx(118.4, abs=0.2)
    assert sorted(a) == sorted(b)
    assert (corpus.lengths(10, {"max": 128}, np.random.default_rng(0)) == 128).all()


def test_training_set_shapes_and_caps():
    g, p, lens, words = corpus.training_set(300, 32, {"min": 6, "max": 32, "full_share": 0.5},
                                            2, seed=2 ** 33 + 5)
    assert g.shape == p.shape == (300, 32, 3) and len(words) == 300
    assert max(words.count(w) for w in set(words)) <= 2
    valid = np.arange(32)[None] < lens[:, None]
    assert (g[~valid] == 0).all() and (p[~valid] == 0).all()
    t = g[..., 2]
    assert np.allclose(t[np.arange(300), lens - 1], 1.0) and (t[:, 0] == 0).all()
    assert (np.diff(t, axis=1)[valid[:, 1:]] >= 0).all()
    again = corpus.training_set(300, 32, {"min": 6, "max": 32, "full_share": 0.5}, 2,
                                seed=2 ** 33 + 5)
    assert (again[0] == g).all() and again[3] == words


def test_prototype_follows_the_keys():
    p = corpus.prototype("ab", 5)
    centers = corpus.key_centers()
    assert np.allclose(p[0, :2], centers["a"]) and np.allclose(p[-1, :2], centers["b"])
    assert np.allclose(p[:, 2], np.linspace(0, 1, 5))
