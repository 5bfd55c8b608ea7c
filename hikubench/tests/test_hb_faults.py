"""The harness drives a whole run on the CPU at a tiny size (its look for a
card skipped), and ``correct`` comes out true for the program as it is and
false with the served path broken underneath: a token altered where it is
produced, a decode step that returns its state unchanged, a request placed
on another worker than Hiku's.  (A serving cell has a batch of one and no
exchange between chips, so those two faults cannot arise.)"""

import copy

import pytest
import torch

from hikubench import harness


def run(tiny_root, name, trace=False):
    return harness.run_cell(harness.load_cell(name, tiny_root), 2**31 + 7, 1.5, trace, "cpu",
                            0.0)


def test_a_sound_run_is_correct(tiny_root, cell_names):
    for name in cell_names:
        res = run(tiny_root, name)
        assert res["correct"], res["checks"]
        assert res["failed"] == 0 and res["attempted"] == 30
        assert list(res)[-1] == "checks"
        cell = harness.load_cell(name, tiny_root)
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_an_altered_token_is_caught(tiny_root, cell_names, monkeypatch):
    from repro_torch.serving import worker

    orig = worker.Instance.generate

    def generate(self, tokens, gen_len=4):
        out = orig(self, tokens, gen_len).clone()
        out[0, 3] = (out[0, 3] + 1) % self.endpoint.cfg.vocab
        return out

    monkeypatch.setattr(worker.Instance, "generate", generate)
    for name in cell_names:
        res = run(tiny_root, name)
        assert not res["correct"] and res["checks"]["logit_gap"]["value"] > \
            res["checks"]["logit_gap"]["limit"]


def test_a_step_that_keeps_its_state_is_caught(tiny_root, cell_names, monkeypatch):
    from repro_torch.models.model import Model

    orig = Model.decode_step

    def decode_step(self, params, tokens, cache, cache_index):
        before = copy.deepcopy(cache)
        logits, _ = orig(self, params, tokens, cache, cache_index)
        return logits, before

    monkeypatch.setattr(Model, "decode_step", decode_step)
    for name in cell_names:
        res = run(tiny_root, name)
        assert not res["correct"]
        assert res["checks"]["decode_kv_err"]["value"] > res["checks"]["decode_kv_err"]["limit"]


def test_a_misplaced_request_is_caught(tiny_root, cell_names, monkeypatch):
    from repro_torch.core.hiku import HikuScheduler

    orig = HikuScheduler.select
    calls = []

    def select(self, func):
        w = orig(self, func)
        calls.append(w)
        return (w + 1) % self.n_workers if len(calls) == 20 else w

    monkeypatch.setattr(HikuScheduler, "select", select)
    res = run(tiny_root, cell_names[0])
    assert not res["correct"] and res["checks"]["placements_wrong"]["value"] > 0


def test_a_traced_run_reports_the_layers(tiny_root, cell_names):
    """Every per-layer metric of a cell that a CPU run can read is there
    (the device's, read from the card's trace, are not)."""
    device_only = {"device_idle_share", "flash_attention_roofline",
                   "decode_attention_roofline"}
    for name in cell_names:
        res = run(tiny_root, name, trace=True)
        assert res["correct"] and "breakdown" in res
        cell = harness.load_cell(name, tiny_root)
        assert set(res["metrics"]) == {m["name"] for m in cell.per_layer} - device_only
        assert res["device"]["window_s"] > 0
