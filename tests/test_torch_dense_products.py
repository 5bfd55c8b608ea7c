"""The dense products' route (``kernels/ops.py``: ``dense``, ``tc_refusal``,
``linear_tf32x3``) on the CPU: which products the card would send to the
tensor-core kernel and which keep ``torch.matmul``, ``dense`` being
``x @ w`` here, the kernel's plain version as the card's route computes
it, and the products an open request record counts.  The kernel itself is
tested on the card (``tests/test_torch_gpu.py``, ``-k linear``)."""

import dataclasses

import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.serving import Endpoint, WorkerHost, telemetry


def _xw(rows=1024, K=256, N=1024, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, K, generator=g), torch.randn(K, N, generator=g) / K ** 0.5


def _misaligned(t):
    """``t``'s values in storage one float past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1)[1:].view(t.shape)
    out.copy_(t)
    return out


def _cases():
    x, w = _xw()  # 8 x 8 tiles of 128: as few as the kernel takes
    table = torch.randn(1000, 256)
    return {
        # what a prefill sends: refused here only for the device
        "prefill": ((x.view(2, 512, 256), w), "device"),
        "prefill_tied_table": ((x, table.T), "device"),
        "prefill_group": ((x, w, w, w, w), "device"),
        # too few tiles to fill half the card
        "few_tiles": ((x[:1000], w[:, :896]), "tiles"),
        "few_tiles_narrow": ((x[:200], w), "tiles"),
        # a decode step: a row a slot
        "decode": ((x[:8].view(8, 1, 256), w), "rows"),
        "vector": ((x[0], w), "rows"),
        "bf16": ((x.bfloat16(), w.bfloat16()), "dtype"),
        "mixed_dtypes": ((x, w.double()), "dtype"),
        "grad_on": ((x, w.clone().requires_grad_()), "grad"),
        "x_row_stride": ((torch.randn(200, 258)[:, :256], w), "strides"),
        "x_base": ((_misaligned(x), w), "strides"),
        "w_row_stride": ((x, torch.randn(256, 386)[:, :384]), "strides"),
        "w_columns": ((x, w[:, ::2]), "strides"),
        "two_layouts": ((x, w, table.T), "strides"),
        "k_mismatch": ((x, torch.randn(128, 384)), "strides"),
        "no_weight": ((x,), "type"),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_refusals(case):
    """``tc_refusal`` names the first thing that keeps a product off the
    kernel: a decode step's rows, bfloat16, a wanted gradient, strides or a
    base TMA cannot read, fewer tiles than half the card's SMs; on the CPU
    every other product is refused for its device alone."""
    args, why = _cases()[case]
    assert ops.tc_refusal(*args) == why


def test_grad_off_and_meta_tensors():
    """A weight that requires a gradient is taken where grad mode is off (the
    serving path's ``no_grad``); tensors without data (the dry run's twins)
    keep ``torch.matmul``, whose dispatch the dry run counts."""
    x, w = _xw()
    w.requires_grad_()
    with torch.no_grad():
        assert ops.tc_refusal(x, w) == "device"
    with torch.device("meta"):
        assert ops.tc_refusal(torch.empty(1024, 256), torch.empty(256, 1024)) == "device"


def test_dense_is_matmul_on_the_cpu():
    """On the CPU ``dense`` is ``x @ w`` bit for bit, one tensor for one
    weight and a list for several, and launches nothing."""
    x, w = _xw()
    x3 = x.view(2, 512, 256)
    ops.reset_launches()
    assert torch.equal(ops.dense(x3, w), x3 @ w)
    outs = ops.dense(x3, w, 2 * w)
    assert isinstance(outs, list) and torch.equal(outs[1], x3 @ (2 * w))
    assert ops.LAUNCHES["linear_tf32x3"] == 0


def test_the_card_route_computes_the_plain_version(monkeypatch):
    """With nothing refused (as on the card) ``dense`` takes
    ``linear_tf32x3``'s launcher, which on the CPU runs its plain version, the
    split-precision product of ``ref.einsum_tf32x3``: each product the
    plain version's, in the input's leading shape, within 1e-6 of float64
    where one TF32 product is not."""
    monkeypatch.setattr(ops, "_tc_plan", lambda x, ws: (None, x.reshape(-1, x.shape[-1]), None))
    x, w = _xw()
    table = torch.randn(1000, 256) * 0.02
    x3 = x.view(2, 512, 256)
    y, logits = ops.dense(x3, w), ops.dense(x3, table.T)
    assert y.shape == (2, 512, 1024) and logits.shape == (2, 512, 1000)
    assert torch.equal(y.view(1024, 1024), ref.linear_tf32x3_ref(x, w))
    assert torch.equal(logits.view(1024, 1000), ref.einsum_tf32x3("mk,kn->mn", x, table.T))
    want = x.double() @ w.double()
    err = float((y.view(1024, 1024).double() - want).abs().max() / want.abs().max())
    one = float((ref.einsum_tf32("mk,kn->mn", x, w).double() - want).abs().max()
                / want.abs().max())
    assert err < 1e-6 < one


def test_linear_tf32x3_checks_its_operands():
    x, w = _xw()
    with pytest.raises(TypeError):
        ops.linear_tf32x3(x.bfloat16(), w)
    with pytest.raises(ValueError):
        ops.linear_tf32x3(x, torch.randn(128, 384))
    with pytest.raises(ValueError):
        ops.linear_tf32x3(x)


def test_an_open_record_counts_the_products():
    """A record counts the weights ``dense`` took while it was open, in
    ``products_other`` (the CPU's route) or ``products_tc``; after it closed
    it counts nothing more."""
    x, w = _xw()
    with telemetry.request("f") as rec:
        ops.dense(x, w)
        ops.dense(x, w, w, w)
    assert (rec.products_tc, rec.products_other) == (0, 4)
    ops.dense(x, w)
    assert (rec.products_tc, rec.products_other) == (0, 4)


def test_a_minicpm_request_counts_seven_products_a_layer_and_the_unembedding():
    """A warm request of reduced minicpm-2b on the CPU, where the prefill and
    each decode step run eagerly: every step's q, k, v, o, gate, up and
    down a layer and the unembedding, all on ``torch.matmul``."""
    cfg = dataclasses.replace(get_config("minicpm_2b").reduced(), n_layers=2)
    ep = Endpoint("m", cfg, seed=1, max_cache_len=32)
    host, gen_len = WorkerHost(0, device="cpu"), 4
    tokens = torch.ones((1, 8), dtype=torch.int32)
    host.execute(ep, tokens, gen_len)
    host.execute(ep, tokens, gen_len)
    rec = telemetry.RING[-1]
    assert not rec.cold
    assert (rec.products_tc, rec.products_other) == (0, gen_len * (7 * cfg.n_layers + 1))
