"""The general traffic generator: repeatable per seed, different across
seeds, shifts on the dyadic grid."""

import numpy as np
import torch

from harness import traffic

BIG = 2 ** 31 + 12345678901       # seeds wider than 32 signed bits


def test_rhs_repeats_per_seed_and_index():
    a = traffic.rhs(1000, BIG, 3, "cpu")
    b = traffic.rhs(1000, BIG, 3, "cpu")
    assert a.dtype == torch.float64
    assert torch.equal(a, b)
    # float32 values widened: exact in float32
    assert torch.equal(a, a.float().double())


def test_rhs_differs_across_seeds_indices_and_streams():
    base = traffic.rhs(1000, BIG, 3, "cpu")
    for other in (traffic.rhs(1000, BIG + 1, 3, "cpu"),
                  traffic.rhs(1000, BIG, 4, "cpu"),
                  traffic.rhs(1000, BIG, 3, "cpu", stream="warm")):
        assert not torch.equal(base, other)


def test_stream_seed_fits_a_generator():
    for seed in (0, 1, BIG, 2 ** 62, -5):
        s = traffic.stream_seed(seed, "rhs", 7)
        assert 0 <= s < 2 ** 63
        torch.Generator().manual_seed(s)


def test_shift_exponents_are_seeded_permutations_on_the_dyadic_grid():
    exps = list(range(11))
    for seed in (1, BIG):
        seq = [traffic.shift_exponent(exps, seed, k) for k in range(33)]
        assert seq == [traffic.shift_exponent(exps, seed, k)
                       for k in range(33)]
        for block in range(3):
            assert sorted(seq[11 * block:11 * block + 11]) == exps
        for j in seq:
            s = traffic.shift(j)
            assert s == 2.0 ** -j and 0 <= j <= 10
            # the shifted centre 6 + s is exact in float32
            assert float(np.float32(6.0 + s)) == 6.0 + s
    a = [traffic.shift_exponent(exps, 1, k) for k in range(22)]
    b = [traffic.shift_exponent(exps, 2, k) for k in range(22)]
    assert a != b


def test_reservoir_is_seeded_and_bounded():
    def sample(seed):
        r = traffic.Reservoir(8, seed)
        for i in range(1000):
            r.offer(i)
        return r.items
    assert sample(BIG) == sample(BIG)
    assert sample(BIG) != sample(BIG + 1)
    assert len(sample(3)) == 8 and len(set(sample(3))) == 8
    r = traffic.Reservoir(8, 1)
    assert [r.offer(i) for i in range(3)] == [0, 1, 2]
    assert r.items == [0, 1, 2]
    for i in range(3, 1000):
        slot = r.offer(i)
        assert slot is None or r.items[slot] == i
