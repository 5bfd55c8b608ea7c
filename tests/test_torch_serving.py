"""The port's serving engine on the CPU with the tiny mamba2 endpoints of
tests/test_serving.py: lifecycle, cold/warm, pull locality, eviction
notifications, failure rerouting, and token parity with the JAX
``Instance.generate`` on the same weights; then the same for the tiny
minicpm-2b endpoint of the serving launcher (the dense family)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

from repro.configs import get_config as jax_get_config
from repro.serving import Endpoint as JaxEndpoint
from repro.serving.worker import Instance as JaxInstance
from repro.launch.serve import _endpoint as jax_launch_endpoint
from repro_torch.configs import get_config
from repro_torch.launch.serve import _endpoint as launch_endpoint
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.mamba import init_mamba_state
from repro_torch.serving import Endpoint, Instance, ServingEngine, WorkerHost


def _tiny_cfg(cfg):
    cfg = cfg.reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=32, vocab=64,
                               ssm=dataclasses.replace(cfg.ssm, d_state=8, headdim=8))


def _tiny_endpoint(name, seed=0):
    return Endpoint(name=name, cfg=_tiny_cfg(get_config("mamba2_130m")), seed=seed, max_cache_len=32)


@pytest.fixture(scope="module")
def engine():
    eps = [_tiny_endpoint(f"f{i}", seed=i) for i in range(3)]
    return ServingEngine(eps, n_workers=2, scheduler="hiku", keep_alive_s=600.0, device="cpu")


def test_cold_then_warm(engine):
    r1 = engine.submit("f0")
    r2 = engine.submit("f0")
    assert r1.cold and not r2.cold and r1.worker == r2.worker
    assert r1.latency_ms > 0 and r2.latency_ms > 0


def test_cold_start_has_init_time():
    host = WorkerHost(0, device="cpu")
    ep = _tiny_endpoint("h")
    tokens = torch.ones((1, 8), dtype=torch.int32)
    cold = host.execute(ep, tokens, 2)
    warm = host.execute(ep, tokens, 2)
    assert cold.cold and cold.init_ms > 0 and cold.exec_ms > 0
    assert not warm.cold and warm.init_ms == 0.0
    assert host.used_bytes == ep.est_bytes()


def test_pull_locality(engine):
    """Repeated requests for one function stick to the warm worker."""
    first = engine.submit("f1")
    workers = {engine.submit("f1").worker for _ in range(4)}
    assert workers == {first.worker}
    assert all(not engine.records[-i].cold for i in range(1, 5))


def test_scheduler_overhead_negligible(engine):
    assert engine.summary()["sched_overhead_ms"] < 1.0


def test_worker_failure_reroutes(engine):
    r = engine.submit("f2")
    dead = r.worker
    engine.fail_worker(dead)
    r2 = engine.submit("f2")
    assert r2.worker != dead
    assert r2.cold  # instance was lost with the worker
    engine.add_worker(dead)


def test_eviction_notifies_scheduler():
    eps = [_tiny_endpoint(f"g{i}", seed=i) for i in range(4)]
    small = eps[0].est_bytes() + eps[1].est_bytes() // 2  # holds ~1 instance
    eng = ServingEngine(eps, n_workers=1, scheduler="hiku", mem_pool_bytes=small, device="cpu")
    eng.submit("g0")
    assert eng.sched.queue_depth("g0") == 1
    eng.submit("g1")  # forces LRU eviction of g0's instance
    assert eng.sched.queue_depth("g0") == 0  # notification removed it
    assert eng.submit("g0").cold


def test_est_bytes_matches_jax():
    j = JaxEndpoint("e", _tiny_cfg(jax_get_config("mamba2_130m")), max_cache_len=32)
    assert _tiny_endpoint("e").est_bytes() == j.est_bytes()
    full_j = JaxEndpoint("e", jax_get_config("mamba2_130m"))
    assert Endpoint("e", get_config("mamba2_130m")).est_bytes() == full_j.est_bytes()


@pytest.mark.parametrize("S,gen_len,seed", [(12, 4, 0), (40, 3, 1), (1, 2, 2)])
def test_generate_matches_jax_tokens(S, gen_len, seed):
    jep = JaxEndpoint("t", _tiny_cfg(jax_get_config("mamba2_130m")), seed=seed, max_cache_len=64)
    jinst = JaxInstance(jep)
    params = params_from_numpy(jax.tree.map(np.asarray, jinst.params), device="cpu")
    ep = Endpoint("t", _tiny_cfg(get_config("mamba2_130m")), seed=seed, max_cache_len=64)
    inst = Instance(ep, device="cpu", params=params)
    tokens = np.random.default_rng(S).integers(0, 64, (2, S)).astype(np.int32)
    want = np.asarray(jinst.generate(jnp.asarray(tokens), gen_len))
    got = inst.generate(torch.from_numpy(tokens), gen_len)
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        ServingEngine([_tiny_endpoint("f0")])
    with pytest.raises(RuntimeError):
        Instance(_tiny_endpoint("f0"))
    with pytest.raises(RuntimeError):
        build_model(_tiny_endpoint("f0").cfg)
    with pytest.raises(RuntimeError):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError):
        init_mamba_state(_tiny_endpoint("f0").cfg, 1)


# ------------------------------------------------------------- dense family
@pytest.mark.parametrize("S,gen_len,seed", [(8, 2, 0), (20, 4, 1), (45, 2, 2)])
def test_dense_generate_matches_jax_tokens(S, gen_len, seed):
    """The launcher's tiny minicpm-2b endpoint (max_cache_len 48; S=45 puts
    the decode index at its clamp, 48 - gen_len - 1)."""
    jep = jax_launch_endpoint("t", seed)
    jinst = JaxInstance(jep)
    params = params_from_numpy(jax.tree.map(np.asarray, jinst.params), device="cpu")
    ep = launch_endpoint("t", seed)
    assert dataclasses.asdict(ep.cfg) == dataclasses.asdict(jep.cfg)
    assert ep.est_bytes() == jep.est_bytes()
    inst = Instance(ep, device="cpu", params=params)
    tokens = np.random.default_rng(S).integers(0, ep.cfg.vocab, (2, S)).astype(np.int32)
    want = np.asarray(jinst.generate(jnp.asarray(tokens), gen_len))
    got = inst.generate(torch.from_numpy(tokens), gen_len)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_engine_cold_then_warm_and_locality():
    eng = ServingEngine([launch_endpoint(f"d{i}", i) for i in range(2)], n_workers=2,
                        scheduler="hiku", device="cpu")
    first = eng.submit("d0", gen_len=3)
    again = [eng.submit("d0", gen_len=3) for _ in range(3)]
    other = eng.submit("d1", gen_len=3)
    assert first.cold and not any(r.cold for r in again) and other.cold
    assert {r.worker for r in again} == {first.worker}
