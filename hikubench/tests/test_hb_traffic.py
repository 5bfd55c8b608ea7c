"""The traffic generator is a pure function of the mix and the seed, gives
every seed the same work, and each mix's weights are the copied
population's."""

import json

import numpy as np
import pytest

from conftest import ROOT
from hikubench import population, traffic

MIXES = sorted(p.stem for p in (ROOT / "hikubench" / "traffic").glob("*.json"))


def _mix(name):
    return traffic.Mix.load(ROOT / "hikubench" / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_window_is_a_pure_function_of_mix_and_seed(name):
    mix = _mix(name)
    a = traffic.window(mix, 2**31 + 5, 51, 2.0, 1000)
    b = traffic.window(mix, 2**31 + 5, 51, 2.0, 1000)
    assert [(r.func, r.due_s, r.gen_len) for r in a] == [(r.func, r.due_s, r.gen_len) for r in b]
    assert all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_work(name):
    mix = _mix(name)
    a = traffic.window(mix, 1, 51, 2.0, 1000)
    b = traffic.window(mix, 2, 51, 2.0, 1000)
    assert len(a) == len(b) == round(2.0 * 51)
    assert [(r.func, r.due_s, len(r.tokens)) for r in a] == \
        [(r.func, r.due_s, len(r.tokens)) for r in b]
    assert any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_window_matches_the_mix(name):
    mix = _mix(name)
    reqs = traffic.window(mix, 9, 51, 2.0, 1000)
    lens = np.array([len(r.tokens) for r in reqs])
    assert lens.min() >= mix.prompt_min and lens.max() <= mix.prompt_max
    # log-uniform about the cited median: the window's median is the span's geometric mean
    assert abs(np.median(lens) - np.sqrt(mix.prompt_min * mix.prompt_max)) <= 2
    assert json.loads((ROOT / "hikubench" / "traffic" / f"{name}.json").read_text())[
        "lengths_source"]
    counts = np.bincount([r.func for r in reqs], minlength=mix.functions)
    assert np.abs(counts - np.array(mix.weights) * len(reqs)).max() < 1.0
    due = np.array([r.due_s for r in reqs])
    assert due[0] == 0.0 and (np.diff(due) > 0).all()
    assert abs(due[-1] - 51) < 51 * 0.15  # the gaps of a 2/s Poisson stream over 51 s


@pytest.mark.parametrize("name", MIXES)
def test_mix_weights_are_the_populations(name):
    d = json.loads((ROOT / "hikubench" / "traffic" / f"{name}.json").read_text())
    pop = d["population"]
    want = population.azure_like_weights(pop["functions"], pop["seed"], pop["population"])
    np.testing.assert_allclose(d["invocation_weights"], want, rtol=0, atol=1e-15)


def test_population_keeps_the_azure_skew():
    w = np.sort(population.population_weights(1000))[::-1]
    assert w[:10].sum() == pytest.approx(0.513)
    assert w[:100].sum() == pytest.approx(0.923)


def test_function_counts_round_by_largest_remainder():
    rng = np.random.default_rng(0)
    c = traffic.function_counts([0.5, 0.25, 0.125, 0.125], 10, rng)
    assert c.sum() == 10 and c[0] == 5 and c[1] in (2, 3)


@pytest.mark.parametrize("name", MIXES)
def test_warmup_is_the_same_for_every_seed(name):
    mix = _mix(name)
    a = [r for _, r in zip(range(12), traffic.warmup(mix, 1, 1000))]
    b = [r for _, r in zip(range(12), traffic.warmup(mix, 2, 1000))]
    assert [(r.func, len(r.tokens)) for r in a] == [(r.func, len(r.tokens)) for r in b]
    assert len(a[0].tokens) == mix.prompt_max


def test_warmup_rules():
    mix = _mix(MIXES[0])
    fill = traffic.Mix(**{**mix.__dict__, "warmup": "fill", "functions": 2,
                          "weights": (0.5, 0.5)})
    assert not traffic.warmup_done(fill, [(0, True)], [[0], []])
    assert traffic.warmup_done(fill, [(0, True), (1, True)], [[0], [1]])
    rounds = traffic.Mix(**{**fill.__dict__, "warmup": "rounds"})
    assert not traffic.warmup_done(rounds, [(0, True), (1, False)], [[0], [1]])
    assert traffic.warmup_done(rounds, [(0, True), (1, True), (1, False), (0, False)],
                               [[0], [1]])
