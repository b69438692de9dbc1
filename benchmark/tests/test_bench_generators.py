"""The traffic generator is a function of the seed: the same seed gives
the same traffic, another seed other traffic, and a seed beyond 32 signed
bits works."""
from benchmark.gen.datagrams import Datagrams


def _datagrams(seed):
    g = Datagrams({"queue": 2, "size": 24}, seed)
    return g.top_up(0, 1, 2) + g.top_up(1, 0, 1)


def test_datagrams_are_a_function_of_the_seed():
    big = 2 ** 31 + 7
    a, b, c = _datagrams(big), _datagrams(big), _datagrams(big + 1)
    assert a == b and a != c
    assert len(a) == 3 + 2 and all(len(d) == 24 for d in a)
    assert len(set(a)) == len(a)
    assert a[0][0] == 0 and a[-1][0] == 1               # the sender's index
