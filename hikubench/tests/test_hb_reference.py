"""The plain references against the port on the CPU, at tiny widths: the
reference cluster's placements against the serving engine's, the weights
``model_ref`` works out against those the served path draws, and the
reference's logits against the served prefill's and decode's."""

import copy
import json

import pytest
import torch

from hikubench import check, cluster_ref, harness, model_ref, traffic


@pytest.fixture(scope="module")
def cells(tiny_root, cell_names):
    return {n: harness.load_cell(n, tiny_root) for n in cell_names}


def test_reference_cluster_places_as_the_engine(cells):
    """The engine over tiny endpoints, pools that hold two instances and a
    skewed stream: every placement and cold start is the reference's, with
    LRU evictions among several instances on a worker."""
    cell = copy.deepcopy(next(iter(cells.values())))
    need = check.instance_bytes(cell.model, cell.config["max_cache_len"])
    cell.mix = traffic.Mix(**{**cell.mix.__dict__, "pool_bytes": int(2.5 * need),
                              "workers": 3, "functions": 9, "weights": (1 / 9,) * 9,
                              "warmup": "fill"})
    sess = harness.Session(cell, "cpu")
    sess.warm_up(3)
    reqs = traffic.window(cell.mix, 3, 2.0, 30.0, cell.model["vocab"])
    out, _ = sess.window(reqs)
    served = sess.served
    sess.close()
    assert sum(r.cold for r in served) > 9 and sum(not r.cold for r in served) > 9
    assert check.placements_wrong(cell, served) == 0
    # the reference is not vacuous: another tie-break seed places otherwise
    ref = cluster_ref.HikuCluster(3, cell.mix.pool_bytes, need, cell.mix.stream_seed + 1)
    assert [ref.serve(f"f{r.func:02d}") for r in served] != [(r.worker, r.cold) for r in served]


def test_lru_evicts_the_least_recently_used():
    c = cluster_ref.HikuCluster(1, 250, 100, seed=0)
    for f in ("a", "b", "a", "c"):  # c evicts b, the least recently used
        c.serve(f)
    assert c.holders() == [["a", "c"]]
    assert c.serve("b") == (0, True) and c.holders() == [["c", "b"]]


def test_weights_are_the_served_paths(cells):
    from repro_torch.models import build_model

    cell = next(iter(cells.values()))
    port = build_model(harness.port_config(cell.config), device="cpu").init(
        torch.Generator().manual_seed(5), max_seq=cell.config["max_cache_len"])
    ref = model_ref.make_params(cell.model, 5, "cpu")
    assert torch.equal(port["embed"]["tokens"], ref["embed"])
    st = port["stack"]
    for i, b in enumerate(ref["blocks"]):
        for ours, theirs in (("wq", st["attn"]["wq"]), ("wo", st["attn"]["wo"]),
                             ("wg", st["mlp"]["wi_gate"]), ("wd", st["mlp"]["wo"])):
            assert torch.equal(b[ours], theirs[i])


def test_reference_logits_match_the_served_path(cells):
    """At every served position the reference's logits are the served path's
    (prefill, then decode steps from a zero cache at ``decode_start``) to
    float32 rounding, and the served tokens are its argmax."""
    from repro_torch.serving.worker import Endpoint, Instance

    cell = next(iter(cells.values()))
    maxlen = cell.config["max_cache_len"]
    inst = Instance(Endpoint("f", harness.port_config(cell.config), seed=2,
                             max_cache_len=maxlen), "cpu")
    prompt = torch.randint(0, cell.model["vocab"], (1, 40), generator=torch.Generator().manual_seed(0))
    served = inst.generate(prompt, 6)[0]
    ref, (keys, values) = model_ref.request_logits(model_ref.make_params(cell.model, 2, "cpu"),
                                                   cell.model, prompt[0], served, maxlen)
    _, first = inst.model.prefill(inst.params, {"tokens": prompt})
    assert check.relative_err(first[0], ref[0]) < 1e-5
    assert float(model_ref.logit_gaps(ref, served).max()) == 0.0
    cache = inst.decode_cache(1)
    idx = min(40, maxlen - 7)
    for t in range(5):
        logits, cache = inst.model.decode_step(inst.params, served[t].view(1, 1), cache, idx + t)
        assert check.relative_err(logits[0], ref[t + 1]) < 1e-5
    k, v = harness._seq_leaves(cache, maxlen)
    assert check.relative_err(k[:, 0, idx:idx + 5], keys) < 1e-5
    assert check.relative_err(v[:, 0, idx:idx + 5], values) < 1e-5


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10), 3.0])
    assert model_ref.tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 3.0]
