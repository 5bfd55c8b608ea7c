"""``repro_torch.utils.comms`` against the JAX package's ``utils/hlo.py``: the
ring-traffic model, and the collective statistics of the HLO parser's own
synthetic module, here made as real collectives in a ``fake`` world of 16
ranks (a subprocess: the world must not outlive the test)."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro.utils import hlo
from repro_torch.utils import comms

ROOT = Path(__file__).resolve().parent.parent

# tests/test_hlo_parser.py's module: in a 12-trip loop an all-reduce of 8
# float32 and an all-gather to 32 over groups of 4, then one all-reduce of
# 1,024 float32 over groups of 2
SYNTH = textwrap.dedent("""\
    HloModule jit_step, is_scheduled=true

    %cond.1 (p: (s32[], f32[8])) -> pred[] {
      %p = (s32[], f32[8]) parameter(0)
      %i = s32[] get-tuple-element(%p), index=0
      %constant.7 = s32[] constant(12)
      ROOT %lt = pred[] compare(%i, %constant.7), direction=LT
    }

    %body.2 (p: (s32[], f32[8])) -> (s32[], f32[8]) {
      %p = (s32[], f32[8]) parameter(0)
      %x = f32[8]{0} get-tuple-element(%p), index=1
      %ar = f32[8]{0} all-reduce(%x), channel_id=1, replica_groups=[4,4]<=[16], to_apply=%add
      %ag = f32[32]{0} all-gather(%x), channel_id=2, replica_groups=[4,4]<=[16], dimensions={0}
      ROOT %t = (s32[], f32[8]) tuple(%i2, %ar)
    }

    ENTRY %main (a: f32[8]) -> f32[8] {
      %a = f32[8]{0} parameter(0)
      %big = f32[1024]{0} all-reduce(%pad), channel_id=3, replica_groups={{0,1},{2,3}}, to_apply=%add
      %w = (s32[], f32[8]) while(%init), condition=%cond.1, body=%body.2
      ROOT %r = f32[8]{0} get-tuple-element(%w), index=1
    }
""")

# the same collectives, run eagerly on fake tensors; also one matrix product
# and one kernel twin, for the census
SYNTH_RUN = """
import json, warnings
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.kernels import ops
from repro_torch.utils.comms import Accounting, collective_stats, op_census, total_collective_bytes

warnings.simplefilter("ignore", FutureWarning)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
g4 = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model")).get_group("model")
g2 = dist.new_group([0, 1])
with FakeTensorMode(), Accounting() as acc:
    x = torch.empty(8)
    for _ in range(12):
        dist.all_reduce(x, group=g4)
        dist.all_gather_into_tensor(torch.empty(32), x, group=g4)
    dist.all_reduce(torch.empty(1024), group=g2)
    torch.empty(4, 8) @ torch.empty(8, 2)
    q = torch.empty(1, 16, 2, 16)
    ops.flash_attention(q, q, q)
stats = collective_stats(acc)
print(json.dumps({"stats": stats, "totals": total_collective_bytes(stats),
                  "census": op_census(acc), "flops": acc.flops}))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("g", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("kind", hlo._KINDS)
def test_traffic_matches_reference(kind, g):
    assert comms.KINDS == hlo._KINDS
    for nbytes in (0, 100, 4096, 12345):
        assert comms._traffic(kind, nbytes, g) == hlo._traffic(kind, nbytes, g)


def test_synthetic_module_stats_match_reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", SYNTH_RUN], env=env, capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = hlo.collective_stats(SYNTH)
    assert got["stats"] == want
    assert tuple(got["totals"]) == hlo.total_collective_bytes(want)
    # one mm and the flash twin, whose operations the twin adds
    assert got["census"] == {"mm": 1, "flash_attention": 1}
    from repro_torch.kernels.counts import flash_counts
    assert got["flops"] == 2 * 4 * 8 * 2 + flash_counts(1, 16, 2, 2, 16, True, None, 4)[1]


def test_total_collective_bytes_of_empty_stats():
    assert comms.total_collective_bytes({}) == hlo.total_collective_bytes({}) == (0, 0)
