"""END-TO-END SERVING DRIVER on the PyTorch port: full §V experiment replay.

Replays the paper's evaluation protocol — 5 workers, 40 Azure-weighted
functions, closed-loop VUs at 20/50/100, seeded identical workloads per
scheduler — through the cluster simulator, scales the same protocol out
across K independent cluster shards via the sharded multi-cluster driver,
demonstrates the global pull-based admission tier balancing a skewed VU
population the static partition can't (with windowed metrics streaming off
the in-flight merge), compares admission policies from the pluggable
registry on a flash-crowd scenario (`pull` vs `deadline`, side by side),
then serves a *real* small model with batched requests through the engine
under the same scheduler, including a worker failure + elastic re-join
mid-run.  The simulated sections print what ``examples/serve_cluster.py``
prints, byte for byte, except the host's wall-clock rates.

    PYTHONPATH=src python examples/serve_cluster_torch.py [--quick] [--shards K]
    PYTHONPATH=src python examples/serve_cluster_torch.py --quick --device cpu

The real-model section serves on the card unless ``--device cpu`` is given;
without a card it raises, it does not fall back to the CPU.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs import get_config
from repro_torch.core import (
    ShardedSimulator,
    SimConfig,
    Simulator,
    default_n_events,
    make_functions,
    make_scheduler,
    summarize,
)
from repro_torch.serving import Endpoint, ServingEngine, telemetry


def replay_paper_protocol(quick: bool):
    duration = 30.0 if quick else 100.0
    vu_levels = [20, 50] if quick else [20, 50, 100]
    print(f"== §V replay: VUs={vu_levels}, {duration:.0f}s each, 5 workers ==")
    print(f"{'scheduler':<20}{'mean ms':>9}{'p99 ms':>9}{'cold':>7}{'CV':>7}{'total':>8}")
    results = {}
    for name in ("hiku", "ch_bl", "least_connections", "random"):
        lat, cold, cvs, total = [], [], [], 0
        for vus in vu_levels:
            sched = make_scheduler(name, 5, seed=11)
            sim = Simulator(sched, cfg=SimConfig(), seed=1000 + vus)
            recs = sim.run(n_vus=vus, duration_s=duration)
            m = summarize(recs, sim.assignments, list(range(5)), duration)
            lat.append(m.mean_latency_ms); cold.append(m.cold_rate)
            cvs.append(m.load_cv); total += m.n_requests
        results[name] = (np.mean(lat), np.mean(cold), np.mean(cvs), total)
        print(f"{name:<20}{np.mean(lat):>9.0f}{'':>9}{np.mean(cold):>7.1%}"
              f"{np.mean(cvs):>7.2f}{total:>8d}")
    h, c = results["hiku"], results["ch_bl"]
    print(f"\nhiku vs ch_bl: latency {100*(c[0]-h[0])/c[0]:+.1f}% "
          f"(paper: 14.9%), cold {h[1]:.0%} vs {c[1]:.0%} (paper: 30% vs 43%), "
          f"throughput {100*(h[3]-c[3])/c[3]:+.1f}% (paper: +8.3%)")


def sharded_scale_out(quick: bool, n_shards: int):
    n_workers, n_vus, dur = (100, 400, 10.0) if quick else (400, 2000, 20.0)
    print(f"\n== sharded multi-cluster driver: {n_shards} shards, "
          f"{n_workers} workers, {n_vus} VUs, {dur:.0f}s ==")
    driver = ShardedSimulator(n_shards, n_workers, scheduler="hiku",
                              cfg=SimConfig(mem_pool_mb=4096.0), seed=3, backend="auto")
    run = driver.run(n_vus=n_vus, duration_s=dur)
    for r in run.shards:
        print(f"  shard {r.spec.index}: seed={r.spec.seed} "
              f"{r.spec.cfg.n_workers}w/{r.spec.n_vus}vu -> {len(r.records)} reqs "
              f"@ {r.n_events / r.wall_s:,.0f} ev/s")
    m = run.summarize(dur)
    print(f"  merged: {m.n_requests} requests, mean {m.mean_latency_ms:.0f} ms, "
          f"p99 {m.p99_ms:.0f} ms, cold {m.cold_rate:.1%}, CV {m.load_cv:.2f}")
    print(f"  makespan {run.wall_s:.2f}s ({run.events_per_s:,.0f} ev/s end-to-end), "
          f"aggregate capacity {run.aggregate_events_per_s:,.0f} ev/s")


def admission_tier(quick: bool, n_shards: int):
    from repro_torch.core import summarize_window
    from repro_torch.core.admission import (
        AdmissionSimulator,
        load_cv_across_shards,
        make_skewed_programs,
    )

    n_workers, n_vus, dur = (16, 32, 10.0) if quick else (32, 96, 30.0)
    n_shards = min(n_shards, n_workers)
    print(f"\n== global pull-based admission tier: {n_shards} shards, "
          f"{n_workers} workers, {n_vus} VUs (25% hot block), {dur:.0f}s ==")
    cfg = SimConfig(mem_pool_mb=1024.0)
    adm = AdmissionSimulator(n_shards, n_workers, scheduler="hiku", cfg=cfg, seed=7)
    programs = make_skewed_programs(adm.funcs, n_vus, default_n_events(dur), 7)

    static = ShardedSimulator(n_shards, n_workers, scheduler="hiku", cfg=cfg,
                              seed=7, backend="auto").run(n_vus, dur, programs=programs)
    pull = adm.run(n_vus, dur, programs=programs)
    s_counts = [len(r.records) for r in static.shards]
    p_counts = pull.shard_requests.tolist()
    print(f"  static partition: per-shard requests {s_counts} "
          f"(cross-shard CV {load_cv_across_shards(s_counts):.2f}), "
          f"p99 {static.summarize(dur).p99_ms:.0f} ms")
    print(f"  pull admission:   per-shard requests {p_counts} "
          f"(cross-shard CV {pull.shard_load_cv:.2f}), "
          f"p99 {pull.summarize(dur).p99_ms:.0f} ms, "
          f"pulls {[s.pulls for s in pull.shards]}")

    # windowed metrics over the *in-flight* sharded run (streaming merge)
    window_s = 2.0 if quick else 5.0
    stream = ShardedSimulator(n_shards, n_workers, scheduler="hiku", cfg=cfg,
                              seed=7, backend="interleaved")
    print(f"  live {window_s:.0f}s windows (streaming merge, static partition):")
    for chunk in stream.run_stream(n_vus, dur, window_s=window_s, programs=programs):
        m = summarize_window(chunk.records, (chunk.assign_t, chunk.assign_w),
                             list(range(n_workers)), chunk.t_lo, chunk.t_hi)
        if m.n_requests:
            print(f"    ({chunk.t_lo:5.1f}, {chunk.t_hi:5.1f}]s: "
                  f"{m.n_requests:4d} reqs, p99 {m.p99_ms:6.0f} ms, "
                  f"cold {m.cold_rate:5.1%}, per-shard {chunk.shard_counts.tolist()}")


def work_stealing(quick: bool, n_shards: int):
    from repro_torch.core.admission import (
        AdmissionConfig,
        AdmissionSimulator,
        make_sleeper_programs,
    )

    n_workers, n_vus, dur = (8, 32, 14.0) if quick else (16, 64, 30.0)
    n_shards = min(n_shards, n_workers)
    nap = (3.0, 5.0) if quick else (6.0, 9.0)
    print(f"\n== cross-shard work stealing: {n_shards} shards, {n_workers} "
          f"workers, {n_vus} VUs (37.5% delayed-onset hot block), {dur:.0f}s ==")
    cfg = SimConfig(mem_pool_mb=1024.0)
    programs = make_sleeper_programs(
        make_functions(seed=0), n_vus,
        default_n_events(dur), 0, hot_frac=0.375, quiet_s=nap)
    n_hot = int(round(0.375 * n_vus))
    arrivals = np.zeros(n_vus)
    arrivals[:n_hot] = np.random.default_rng((0, 0xA11CE)).uniform(1.0, 4.0, n_hot)
    for policy in ("pull", "pull+steal"):
        adm = AdmissionSimulator(
            n_shards, n_workers, scheduler="hiku", cfg=cfg, seed=0,
            admission=AdmissionConfig(policy=policy, steal_watermark=1.25))
        r = adm.run(n_vus, dur, programs=programs, arrivals=arrivals)
        m = r.summarize(dur)
        extra = ""
        if policy == "pull+steal":
            extra = (f", {r.n_migrations} migrations "
                     f"(in/out {[(s.stolen_in, s.stolen_out) for s in r.shards]})")
        print(f"  {policy:10s}: per-shard requests {r.shard_requests.tolist()} "
              f"(cross-shard CV {r.shard_load_cv:.2f}), p99 {m.p99_ms:.0f} ms"
              f"{extra}")


def policy_comparison(quick: bool, n_shards: int):
    """Same flash-crowd scenario under `pull` vs `deadline` admission,
    printed side by side."""
    import warnings

    from repro_torch.core import available_policies, make_scenario
    from repro_torch.core.admission import AdmissionConfig, AdmissionSimulator

    n_workers, n_vus, dur = (8, 32, 14.0) if quick else (32, 96, 40.0)
    n_shards = min(n_shards, n_workers)
    print(f"\n== admission-policy registry: {available_policies()} ==")
    print(f"   flash crowd: {n_shards} shards, {n_workers} workers, {n_vus} VUs "
          f"(60% spike, half on 2s first-response SLOs), {dur:.0f}s")
    cfg = SimConfig(mem_pool_mb=1024.0)
    scn = make_scenario("flash_crowd", make_functions(seed=0), n_vus, dur, seed=0)
    print(f"   {'policy':<10}{'p99 ms':>8}{'miss':>7}{'cold':>7}{'CV':>7}"
          f"{'admitted':>10}{'requests':>10}")
    for policy in ("pull", "deadline"):
        adm = AdmissionSimulator(n_shards, n_workers, scheduler="hiku",
                                 cfg=cfg, seed=0,
                                 admission=AdmissionConfig(policy=policy))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r = adm.run(scn.n_vus, dur, **scn.run_kwargs())
        m = r.summarize(dur)
        print(f"   {policy:<10}{m.p99_ms:>8.0f}{m.deadline_miss_rate:>7.2f}"
              f"{m.cold_rate:>7.1%}{r.shard_load_cv:>7.2f}{r.admitted:>10d}"
              f"{m.n_requests:>10d}")
    print("   (deadline = EDF-ordered global queue: tight-SLO VUs admitted "
          "ahead of the backlog; see docs/POLICIES.md)")


def serve_real_batched(quick: bool, device="cuda"):
    """Tiny minicpm endpoints behind hiku on ``device``: the card by default
    (an error without one), ``"cpu"`` for the plain path."""
    device = default_device(None if device == "cuda" else device)
    print(f"\n== real-model serving with batched requests + failure/elastic, {device} ==")
    cfg = get_config("minicpm_2b").reduced()
    cfg = dataclasses.replace(cfg, n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                              head_dim=16, d_ff=64, vocab=64)
    eps = [Endpoint(f"llm-{i}", cfg, seed=i, max_cache_len=48) for i in range(4)]
    eng = ServingEngine(eps, n_workers=3, scheduler="hiku", device=device)
    rng = np.random.default_rng(0)
    n = 8 if quick else 16
    for i in range(n):
        f = f"llm-{rng.integers(0, 4)}"
        tokens = torch.ones((4, 8), dtype=torch.int32)  # batch of 4 requests
        r = eng.submit(f, tokens=tokens, gen_len=3)
        tag = "COLD" if r.cold else "warm"
        print(f"  [{i:02d}] {f} -> w{r.worker} {tag:4s} {r.latency_ms:8.1f} ms")
        if i == n // 2:
            victim = r.worker
            print(f"  !! failing worker {victim} (instances lost, queues purged)")
            eng.fail_worker(victim)
            eng.add_worker(99)
            print("  ++ elastic join: worker 99 registered")
    s = eng.summary()
    print(f"  summary: {s['n']} batched requests, cold_rate={s['cold_rate']:.0%}")
    recs = list(telemetry.RING)[-s["n"]:]  # the program's own records of these requests
    means = {k: np.mean([r.span_ms(k) for r in recs if r.span(k) is not None])
             for k in ("materialise", "capture", "generate")}
    print("  mean spans: " + ", ".join(f"{k} {v:.1f} ms" for k, v in means.items())
          + " (materialise and capture: cold starts only)")
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--shards", type=int, default=4,
                    help="shard count for the multi-cluster driver section")
    ap.add_argument("--device", default="cuda",
                    help='device to serve on (default: the card; "cpu" runs the plain path)')
    args = ap.parse_args(argv)
    replay_paper_protocol(args.quick)
    sharded_scale_out(args.quick, args.shards)
    admission_tier(args.quick, args.shards)
    work_stealing(args.quick, args.shards)
    policy_comparison(args.quick, args.shards)
    serve_real_batched(args.quick, args.device)


if __name__ == "__main__":
    main()
