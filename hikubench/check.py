"""The comparison that decides ``correct``.

Four numbers, each against its limit (``cells/<cell>.json``'s ``limits``
where it is not 0):

- ``placements_wrong``: requests (the warm-up's and the window's, in the
  order served) whose worker or cold/warm outcome differs from the plain
  reference cluster's (``cluster_ref.HikuCluster``) fed the same stream.
  An exact comparison: limit 0.
- ``tokens_missing``: requests of the window that returned no tokens, or
  tokens of another count or outside the vocabulary.  Limit 0.
- ``logit_gap``: over every request of the window, the widest gap by which a served token's logit lies below the best
  logit of the plain reference model (``model_ref``) at that position, the
  reference reading the same prompt and the served tokens: every served
  token, the prefill's and each decode replay's.
- ``prefill_logit_err``: over the same requests, the largest difference
  between the logits the served prefill returned (captured at its return)
  and the reference's at the prompt's last position, as a share of the
  reference's largest logit magnitude.
- ``decode_kv_err``: over the same requests, the largest difference between
  the keys (rotated) and values the decode replays wrote into the decode
  cache, every attention application's at every decode position, and the
  reference's, as a share of the reference's largest magnitude (keys and
  values apart).  It reads the captured steps at full width where the
  served tokens cannot: a random-weight model whose greedy tokens repeat
  their input shows no decode fault in its tokens.

A limit lies between the program's readings over a dozen seeds and the
control's (the reference itself with TF32 products, in the program's
place) on the card; ``PERF.md`` gives both.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import cluster_ref, model_ref


def instance_bytes(cfg: Dict, max_cache_len: int) -> int:
    """An instance's share of its worker's pool under the deployment's
    sizing rule: its float32 weights with a fifth more, and 64 KiB a
    cache position."""
    return int(model_ref.param_count(cfg) * 4 * 1.2) + 64 * max_cache_len * 1024


def placements_wrong(cell, served: List) -> int:
    mix = cell.mix
    ref = cluster_ref.HikuCluster(mix.workers, mix.pool_bytes,
                                  instance_bytes(cell.model, cell.config["max_cache_len"]),
                                  mix.stream_seed)
    wrong = 0
    for r in served:
        w, cold = ref.serve(f"f{r.func:02d}")
        wrong += r.failed or (w, cold) != (r.worker, r.cold) or cold != (r.built > 0)
    return int(wrong)


def well_formed(r, vocab: int) -> bool:
    t = r.tokens
    return (t is not None and tuple(t.shape) == (r.gen_len,)
            and bool(((t >= 0) & (t < vocab)).all()))


def relative_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    got = got.to(ref.device, ref.dtype)
    return float((got - ref).abs().max() / ref.abs().max())


#: the served token the ``token`` fault alters, and by how much
FAULT_POSITION, FAULT_SHIFT = 3, 1


def readings(cell, reqs: List, window: List, idx: List[int], device: str,
             control: bool = False) -> Dict[str, np.ndarray]:
    """The check's readings of requests ``idx``, one entry a request:
    ``gap`` (the widest logit gap of its served tokens), ``prefill`` (its
    prefill's relative logit error) and ``decode_kv`` (its decode keys' and
    values' relative error).  With ``control`` the TF32 reference
    stands in the program's place (the gap of the token it puts first at
    each served position, its prefill logits and decode keys and values),
    and ``fault`` reads the gap
    of a served token altered where it is produced.  Weights are worked out
    once a function."""
    import torch

    cfg, maxlen = cell.model, cell.config["max_cache_len"]
    model_ref.setup_precision()
    out = {k: {} for k in ("gap", "prefill", "decode_kv", "fault")}
    by_func: Dict[int, List[int]] = {}
    for i in idx:
        by_func.setdefault(reqs[i].func, []).append(i)
    for f, members in sorted(by_func.items()):
        params = model_ref.make_params(cfg, cell.mix.weight_seed_base + f, device)
        for i in members:
            prompt, served = torch.from_numpy(reqs[i].tokens), window[i].tokens
            logits, kv = model_ref.request_logits(params, cfg, prompt, served, maxlen)
            if control:
                low, low_kv = model_ref.request_logits(params, cfg, prompt, served, maxlen,
                                                       control=True)
                gaps = model_ref.logit_gaps(logits, served, low.argmax(-1))
                out["prefill"][i] = relative_err(low[0], logits[0])
                out["decode_kv"][i] = max(relative_err(a, b) for a, b in zip(low_kv, kv))
                bad = served.clone()
                bad[FAULT_POSITION] = (bad[FAULT_POSITION] + FAULT_SHIFT) % cfg["vocab"]
                out["fault"][i] = float(model_ref.logit_gaps(logits, bad).max())
            else:
                gaps = model_ref.logit_gaps(logits, served)
                got, got_kv = window[i].first_logits, window[i].decode_kv
                out["prefill"][i] = (relative_err(got, logits[0]) if got is not None
                                     else float("inf"))
                out["decode_kv"][i] = (max(relative_err(a, b) for a, b in zip(got_kv, kv))
                                       if got_kv is not None and len(got_kv) == 2
                                       and got_kv[0].shape == kv[0].shape else float("inf"))
            out["gap"][i] = float(gaps.max())
        del params
    return {k: np.array([v[i] for i in idx]) for k, v in out.items() if v}


def run_checks(cell, warm: List, window: List, reqs: List, device: str) -> Dict:
    vocab = cell.model["vocab"]
    bad = [i for i, r in enumerate(window) if not well_formed(r, vocab)]
    idx = [i for i in range(len(reqs)) if i not in bad]
    got = readings(cell, reqs, window, idx, device)
    limits = cell.spec["limits"]
    out = {"placements_wrong": {"value": placements_wrong(cell, warm + window), "limit": 0},
           "tokens_missing": {"value": len(bad), "limit": 0}}
    for name, key in (("logit_gap", "gap"), ("prefill_logit_err", "prefill"),
                      ("decode_kv_err", "decode_kv")):
        vals = got.get(key, np.zeros(0))
        out[name] = {"value": float(vals.max()) if vals.size else 0.0, "limit": limits[name]}
    return out


def passed(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
