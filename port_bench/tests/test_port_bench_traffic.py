"""The Zipf token generator."""

import numpy as np

from port_bench.cells import resolve
from port_bench.traffic import zipf_lm


def generator(seed):
    c = resolve("gpt2_small.pretrain")
    return zipf_lm.make(c["traffic"], c["model"], seed)


def test_repeats_for_a_seed_and_differs_across_seeds():
    seed = 2**31 + 17
    a, b, c = generator(seed), generator(seed), generator(seed + 1)
    assert np.array_equal(a.rows(5, 0, 4), b.rows(5, 0, 4))
    assert not np.array_equal(a.rows(5, 0, 4), c.rows(5, 0, 4))
    assert not np.array_equal(a.rows(5, 0, 4), a.rows(6, 0, 4))


def test_rows_do_not_depend_on_the_split():
    g = generator(3)
    assert np.array_equal(g.rows(2, 0, 8)[4:], g.rows(2, 4, 8))


def test_ids_are_published_and_zipf_shaped():
    g = generator(11)
    rows = g.rows(0, 0, 16)
    assert rows.dtype == np.int32 and rows.shape == (16, 1025)
    assert rows.min() >= 0 and rows.max() < 50257
    counts = np.bincount(rows.ravel(), minlength=50257)
    top = g.ids[0]  # rank 1
    # Zipf(1) over 50257 ranks: rank 1 is 1 / H(50257) ~ 8.9% of tokens.
    assert counts.argmax() == top
    assert 0.07 < counts[top] / rows.size < 0.11
