"""The port's dry run: cells traced in a fake world, and the counting mode.

Every case joins a fake process group, so each runs in a subprocess (the
pytest worker never joins one).  The machinery on a (2, 4) fake mesh, as
the reference's ``test_dryrun_machinery_small_mesh``: reduced mixtral's
train cell and its decode cell trace, with FLOPs and bytes above 0 (and
granite's prefill through flash's shape-only stand-in); the roofline
methodology's depth fit, as the reference's ``test_linear_fit_predicts_L3``;
a world of one held to a real step on the CPU; the
counting mode gives known collective bytes for known redistributions;
``REPRO_DRYRUN`` traces the paper's flagship greedy step on 256 fake
ranks without allocating its data; each tensor-parallel mode's traced
train step moves the collectives the mode exists for.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(code: str, args=(), timeout=600) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code, *args], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


_MACHINERY = """
import json, sys, torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.compat import make_auto_mesh
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import init_fake_world
from repro_torch.models.config import ShapeConfig
init_fake_world(8)
mesh = make_auto_mesh((2, 4), ("data", "model"), "cpu")
out = {}
cfg = get_reduced("mixtral-8x7b")
for kind in ("train", "decode"):
    fn, mk, extra = D.build_cell(cfg, ShapeConfig(kind, 64, 8, kind), mesh)
    rec = D.trace(fn, mk, mesh)
    out[kind] = [rec["cost"]["flops"], rec["cost"]["bytes"],
                 rec["memory"]["argument_size_in_bytes"],
                 rec["memory"]["temp_size_in_bytes"]]
# flash's traced stand-in under the mesh (granite's prefill)
cfg = get_reduced("granite-3-8b").replace(attn_impl="flash")
fn, mk, _ = D.build_cell(cfg, ShapeConfig("p", 64, 8, "prefill"), mesh)
rec = D.trace(fn, mk, mesh)
out["prefill_flash"] = [rec["cost"]["flops"], rec["cost"]["bytes"],
                        rec["memory"]["argument_size_in_bytes"],
                        rec["memory"]["temp_size_in_bytes"]]
# known redistributions of an (8, 64) float32 tensor, local (4, 16)
with D.fake_world_mode():
    x = DTensor.from_local(torch.empty(4, 16), mesh, [Shard(0), Shard(1)],
                           run_check=False)
    p = DTensor.from_local(torch.empty(4, 64), mesh, [Shard(0), Partial()],
                           run_check=False)
    c = R.CostCounter()
    with c:
        x.redistribute(mesh, [Shard(0), Replicate()])   # all-gather
        p.redistribute(mesh, [Shard(0), Replicate()])   # all-reduce
        p.redistribute(mesh, [Shard(0), Shard(1)])      # reduce-scatter
        x.redistribute(mesh, [Shard(0), Shard(0)])      # all-to-all
    out["coll"] = c.terms()
# the roofline methodology: reduced stablelm at L = 1, 2, 3 (float32,
# einsum, no remat), sequence 128, batch 8
shape = ShapeConfig("t", 128, 8, "train")
out["fit"] = []
for L in (1, 2, 3):
    cfg = get_reduced("stablelm-3b").replace(
        n_layers=L, attn_impl="einsum", remat=False, dtype="float32")
    fn, mk, _ = D.build_cell(cfg, shape, mesh, n_micro=1)
    out["fit"].append(D.trace(fn, mk, mesh)["cost"])
# grounding in a world of one: reduced stablelm (bf16, remat, 2
# microbatches) traced on a (1, 1) mesh against one real step on the CPU
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import close_ranks
from repro_torch.training import make_train_step, train_state_init
from repro_torch.tree import leaves
close_ranks()
init_fake_world(1)
mesh1 = make_auto_mesh((1, 1), ("data", "model"), "cpu")
cfg = get_reduced("stablelm-3b").replace(dtype="bfloat16", remat=True)
fn, mk, _ = D.build_cell(cfg, ShapeConfig("t", 32, 4, "train"), mesh1,
                         n_micro=2)
rec = D.trace(fn, mk, mesh1)
state = train_state_init(cfg, 0, device="cpu")
batch = SyntheticLMData(cfg.vocab_size, 32, 4, seed=0, device="cpu").batch(0)
real_bytes = sum(t.nbytes for t in leaves((state, batch)))
c = R.CostCounter()
with c:
    make_train_step(cfg, n_microbatches=2)(state, batch)
out["one"] = {"traced_args": rec["memory"]["argument_size_in_bytes"],
              "real_args": real_bytes, "traced_flops": rec["cost"]["flops"],
              "real_flops": c.flops}
# REPRO_DRYRUN's flagship step, in a world of 256 of its own
from repro_torch.launch import reduce
close_ranks()
out["gw"] = reduce.dryrun("single", sys.argv[1], "cpu")
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def machinery(tmp_path_factory):
    out = tmp_path_factory.mktemp("gw")
    rec = _run(_MACHINERY, args=[str(out)])
    rec["gw_dir"] = str(out)
    return rec


@pytest.mark.parametrize("kind", ["train", "decode", "prefill_flash"])
def test_dryrun_machinery_small_mesh(machinery, kind):
    flops, nbytes, args, temp = machinery[kind]
    assert flops > 0 and nbytes > 0 and args > 0 and temp > 0


def test_linear_fit_predicts_L3(machinery):
    """The roofline variant's depth fit: the 1-2 layer fit's L = 3
    prediction matches the traced L = 3 within the reference's 1% (FLOPs),
    2% (bytes) and 5% (collective bytes)."""
    from repro_torch.launch.roofline import fit_linear

    c1, c2, c3 = machinery["fit"]
    fit = fit_linear(c1, c2, 1, 2, 3)
    assert fit["flops"] == pytest.approx(c3["flops"], rel=0.01)
    assert fit["bytes"] == pytest.approx(c3["bytes"], rel=0.02)
    assert fit["collective_bytes"] == pytest.approx(
        c3["collective_bytes"], rel=0.05)
    # each layer adds work of every kind: the fit is not of constants
    for k in ("flops", "bytes", "collective_bytes"):
        assert c1[k] < c2[k] < c3[k]


def test_trace_in_a_world_of_one_matches_a_real_step(machinery):
    """A world of one against the CPU: the predicted argument bytes are
    the bytes a real train state and batch hold, and the traced FLOPs the
    counting mode's on one real step (reduced stablelm, bf16, remat, two
    microbatches), both exactly."""
    one = machinery["one"]
    assert one["traced_args"] == one["real_args"]
    assert one["traced_flops"] == one["real_flops"] > 0


def test_counting_mode_gives_known_collective_bytes(machinery):
    """Result bytes by kind: an all-gather to (4, 64) f32 is 1024 bytes,
    the all-reduce of a (4, 64) partial 1024 (counted twice in the total),
    its reduce-scatter to (4, 16) 256, the all-to-all to (1, 64) 256."""
    c = machinery["coll"]
    d = c["collective_detail"]
    assert d["all-gather"] == 1024 and d["all-reduce"] == 1024
    assert d["reduce-scatter"] == 256 and d["all-to-all"] == 256
    assert c["collective_bytes"] == 1024 + 2 * 1024 + 256 + 256


def test_repro_dryrun_flagship_on_256_fake_ranks(machinery):
    """REPRO_DRYRUN at 10,000 x 3,276,800 complex64 on the 256-rank mesh:
    the arguments are S's shard plus the state's, and the traced FLOPs
    are at least the useful 8 N M / P."""
    rec = machinery["gw"]
    N, M = rec["shape"]
    P, K = rec["devices"], 100
    assert (N, P) == (10_000, 256) and M % P == 0 and M >= 3_276_800
    m = M // P
    state = (N * K + K * m) * 8 + 2 * m * 4 + K * 4 + K * 4 + 8
    assert rec["memory"]["argument_size_in_bytes"] == N * m * 8 + state
    assert rec["per_device_cost"]["flops"] >= 8 * N * m
    assert rec["useful_flops_per_device"] == 8 * N * m
    assert (Path(machinery["gw_dir"]) / "gw_greedy__single.json").exists()


@pytest.fixture(scope="module")
def mesh_moe():
    """Two CPU gloo ranks run the MoE block's mesh path (one spawn)."""
    import _torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn_ranks

    return spawn_ranks(ranks.mesh_moe_block, 2, args=((1.25, 0.5),),
                       device="cpu", timeout_s=300)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_mesh_moe_dispatch_matches_the_index_path(mesh_moe,
                                                  capacity_factor):
    """The index dispatch and combine on DTensors (each rank's own
    groups, by ``local_map``; the experts' products by DTensor) compute
    what the plain path computes, drops included (float32, two gloo
    ranks: groups over data, and the hidden dim over model)."""
    for rank in mesh_moe:
        for shape in ("(2, 1)", "(1, 2)"):
            diff, scale = rank[f"{shape}-{capacity_factor}"]
            assert diff <= 1e-5 * scale, (shape, diff, scale)


_TP_MODES = """
import json, torch
from repro_torch.compat import make_auto_mesh
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import init_fake_world
from repro_torch.models.config import ShapeConfig
from repro_torch.sharding import use_mesh


class Recorder(R.CostCounter):
    # each collective's kind, dtype and result elements, besides the sums
    def __init__(self):
        super().__init__()
        self.events = []

    def _count(self, func, args, kwargs, out):
        super()._count(func, args, kwargs, out)
        kind = R._COLLECTIVE_KIND.get(func.overloadpacket.__name__)
        if func.namespace in ("_c10d_functional", "_dtensor", "c10d") \
                and kind is not None:
            self.events += [(kind, str(t.dtype).split(".")[-1], t.numel())
                            for t in R._tensors(out)]


init_fake_world(4)
mesh = make_auto_mesh((2, 2), ("data", "model"), "cpu")
base = get_reduced("stablelm-3b").replace(dtype="bfloat16")
out = {}
for name, over in (("megatron", {}), ("ulysses", {"tp_mode": "ulysses"}),
                   ("megatron_rs", {"tp_mode": "megatron_rs"}),
                   ("opt_collectives", {"opt_collectives": True})):
    cfg = base.replace(**over)
    fn, mk, _ = D.build_cell(cfg, ShapeConfig("t", 32, 8, "train"), mesh,
                             n_micro=1)
    with D.fake_world_mode(), use_mesh(mesh):
        args = mk()
        c = Recorder()
        with c:
            fn(*args)
    out[name] = {"detail": c.terms()["collective_detail"],
                 "events": c.events}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def tp_collectives():
    """One traced train step of reduced stablelm-3b in bfloat16 (batch 8
    x 32 tokens, one microbatch, remat) per tensor-parallel mode in a fake
    (2, 2) ("data", "model") world: each collective's kind, dtype and
    result elements, and the bytes by kind."""
    return _run(_TP_MODES)


# the local activation (B / dp, S / tp, d) of that step: 4 x 16 x 64
_ACT = 4 * 16 * 64
_LAYERS = 2


@pytest.mark.parametrize("mode", ["megatron", "ulysses", "megatron_rs",
                                  "opt_collectives"])
def test_each_tp_mode_moves_its_collectives(tp_collectives, mode):
    """megatron_rs merges its sub-blocks by bf16 reduce-scatters of the
    activation (two a layer forward at least); ulysses moves activations
    by all-to-all and all-reduces no block activation (local or gathered
    over the sequence); the norm's
    sequence all-gather under opt_collectives moves bf16 words (the
    layout the port keeps at both values).  Prints the collective bytes
    by kind."""
    rec = tp_collectives[mode]
    print(mode, rec["detail"])
    ev = rec["events"]
    if mode == "megatron_rs":
        rs = [e for e in ev if e[0] == "reduce-scatter" and e[2] == _ACT]
        assert len(rs) >= 2 * _LAYERS and all(e[1] == "bfloat16"
                                              for e in rs), rs
    elif mode == "ulysses":
        # (the vocab-parallel loss all-reduces its (B/dp, S, V/tp) float32
        # logits' pieces in every mode: not a block activation)
        assert rec["detail"]["all-to-all"] > 0
        assert not [e for e in ev if e[0] == "all-reduce"
                    and e[2] in (_ACT, 2 * _ACT)], ev
    elif mode == "opt_collectives":
        ag = [e for e in ev if e[0] == "all-gather" and e[2] == 2 * _ACT]
        assert len(ag) >= 2 * _LAYERS and all(e[1] == "bfloat16"
                                              for e in ag), ag
    assert sum(rec["detail"].values()) > 0
