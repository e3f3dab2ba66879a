import json

import numpy as np
import pytest

from perfbench.harness import traffic
from perfbench.tests.conftest import REPO

CHAT = json.loads((REPO / "perfbench/traffic/chat.json").read_text())
LONG = json.loads((REPO / "perfbench/traffic/long-decode.json").read_text())


def _draw(mix, seed, rate=1.2, seconds=51, s_max=4096):
    return traffic.generate(mix, {"rate_rps": rate}, seed, seconds, 152064,
                            s_max)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 4000000007])
def test_same_seed_same_requests(seed):
    a, b = _draw(CHAT, seed), _draw(CHAT, seed)
    assert [(p.arrival, p.prompt_len, p.max_new_tokens) for p in a] == \
        [(p.arrival, p.prompt_len, p.max_new_tokens) for p in b]
    assert all(np.array_equal(p.tokens, q.tokens) for p, q in zip(a, b))


def test_seeds_share_sizes_and_arrivals():
    """Every seed gets the same sizes and the same number of arrivals; the
    seed draws the arrival times, the order of the sizes and the ids."""
    a, b = _draw(CHAT, 1), _draw(CHAT, 2)
    assert len(a) == len(b)
    assert [p.arrival for p in a] != [p.arrival for p in b]
    assert sorted(p.prompt_len for p in a) == sorted(p.prompt_len for p in b)
    assert sorted(p.max_new_tokens for p in a) == \
        sorted(p.max_new_tokens for p in b)
    assert [p.prompt_len for p in a] != [p.prompt_len for p in b]
    assert [p.max_new_tokens for p in a] != [p.max_new_tokens for p in b]
    assert not all(np.array_equal(p.tokens, q.tokens) for p, q in zip(a, b))


def test_open_loop_rate_and_clips():
    ps = _draw(CHAT, 5, rate=2.0, seconds=51)
    arr = np.array([p.arrival for p in ps])
    span = CHAT["warmup_s"] + 51
    assert np.all(np.diff(arr) > 0) and 0 < arr[0] and arr[-1] < span
    assert len(ps) == round(2.0 * span)
    assert min(p.prompt_len for p in ps) >= 32
    assert max(p.prompt_len for p in ps) <= 2048
    assert min(p.max_new_tokens for p in ps) >= 16
    assert max(p.max_new_tokens for p in ps) <= 1024
    med = np.median([p.max_new_tokens for p in ps])
    assert 200 <= med <= 320


def test_sessions_fill_the_cache():
    ps = _draw(LONG, 9, s_max=8192)
    assert len(ps) == 32 and all(p.arrival == 0.0 for p in ps)
    assert all(1024 <= p.prompt_len <= 3584 for p in ps)
    assert all(p.prompt_len + p.max_new_tokens == 8190 for p in ps)


def test_request_longer_than_the_cache_is_refused():
    with pytest.raises(ValueError, match="does not fit"):
        _draw(CHAT, 1, s_max=2048)


@pytest.mark.parametrize("law,cv", [({"dist": "exponential"}, 1.0),
                                     ({"dist": "gamma", "cv": 2.0}, 2.0),
                                     ({"dist": "gamma", "cv": 3.0}, 3.0)])
def test_arrival_law_from_the_mix(law, cv):
    """The mix's arrival law sets the gaps: pooled over seeds, their
    coefficient of variation is the law's (1 for Poisson), and Poisson
    keeps its bursts: about 1 - e^-0.1 of the gaps under a tenth of the
    mean, where an evenly spread order would have none."""
    mix = dict(CHAT, arrivals=law)
    g = np.concatenate([np.diff(np.concatenate(
        [[0.0], [p.arrival for p in _draw(mix, seed)]]))
        for seed in range(40)])
    assert abs(g.std() / g.mean() - cv) < 0.2 * cv
    if cv == 1.0:
        assert abs(np.mean(g < 0.1 * g.mean()) - (1 - np.exp(-0.1))) < 0.03


def test_unknown_arrival_law_is_refused():
    with pytest.raises(ValueError, match="arrival law"):
        _draw(dict(CHAT, arrivals={"dist": "uniform"}), 1)
