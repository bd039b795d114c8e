"""The port's sharding rules against the JAX package's.

Logical-axis resolution, the parameter spec trees (one spec a parameter
leaf: the reference's stacked spec without its leading ``None``s), the
meta-device shapes of ``abstract_params``, the no-op ``constrain``, the
production meshes in a fake world, and each leaf's local shard shape on a
(2, 4) mesh against JAX's ``NamedSharding.shard_shape``.  Anything that
joins a process group runs in a subprocess.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_reduced as jax_reduced
from repro.models import api as jax_api
from repro.sharding import resolve as jax_resolve
from repro_torch.configs import get_reduced
from repro_torch.models import api
from repro_torch.models.transformer import hybrid_layout, vlm_layout
from repro_torch.sharding import constrain, resolve
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["stablelm-3b", "mixtral-8x7b", "mamba2-780m", "recurrentgemma-9b",
         "llama-3.2-vision-11b", "seamless-m4t-medium"]


class _Names:
    def __init__(self, names):
        self.axis_names = names          # the JAX package reads these
        self.mesh_dim_names = names      # the port reads these


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model")])
def test_resolve_matches_jax(names):
    m = _Names(names)
    for logical in [("dp", None), ("fsdp", "tp"), (None, "sp", None),
                    ("cols",), ("tp", "fsdp"), ("dp", "sp", None)]:
        mine, ref = resolve(m, *logical), jax_resolve(m, *logical)
        assert isinstance(ref, JP)
        # JAX writes a one-axis tuple entry as the axis itself
        assert [e[0] if isinstance(e, tuple) and len(e) == 1 else e
                for e in mine] == list(ref), logical
        assert ref == JP(*mine)


def _strip(tree, n):
    """The reference's stacked spec tree without its n leading Nones."""
    if isinstance(tree, dict):
        return {k: _strip(v, n) for k, v in tree.items()}
    assert tree[:n] == (None,) * n, tree
    return tuple(tree[n:])


def _expected(cfg, ref):
    """The port's spec tree, from the reference's stacked one."""
    if cfg.family == "encdec":
        return ref._replace(
            enc_blocks=[_strip(ref.enc_blocks, 1)] * cfg.encoder_layers,
            dec_blocks=[_strip(ref.dec_blocks, 1)] * cfg.n_layers)
    out = {"embed": ref.embed, "final_norm": ref.final_norm,
           "lm_head": ref.lm_head, "vision_proj": ref.vision_proj,
           "tail": None, "cross": None}
    if cfg.family == "hybrid":
        n_super, n_rec, n_tail = hybrid_layout(cfg)
        out["blocks"] = [{"recs": [_strip(ref.blocks["recs"], 2)] * n_rec,
                          "attn": _strip(ref.blocks["attn"], 1)}] * n_super
        if n_tail:
            out["tail"] = [_strip(ref.tail, 1)] * n_tail
    elif cfg.family == "vlm":
        n_groups, per = vlm_layout(cfg)
        out["blocks"] = [_strip(ref.blocks, 2)] * (n_groups * per)
        out["cross"] = [_strip(ref.cross, 1)] * n_groups
    else:
        out["blocks"] = [_strip(ref.blocks, 1)] * cfg.n_layers
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    """The spec tree covers the parameters leaf for leaf with the
    reference's specs, and abstract_params has init_params' shapes and
    dtypes on the meta device."""
    cfg = get_reduced(arch)
    specs = api.param_specs(cfg)
    want = _expected(cfg, jax_api.param_specs(jax_reduced(arch)))
    if cfg.family == "encdec":
        assert specs == want
    else:
        assert specs._asdict() == want
    abstract = leaves(api.abstract_params(cfg))
    real = leaves(api.init_params(cfg, 0, device="cpu"))
    assert len(abstract) == len(real)
    for a, r in zip(abstract, real):
        assert a.device.type == "meta"
        assert (a.shape, a.dtype) == (r.shape, r.dtype)
    # one spec per leaf, of the leaf's rank
    flat = []

    def walk(t):
        if isinstance(t, tuple) and not hasattr(t, "_fields") and all(
                x is None or isinstance(x, str) for x in t):
            flat.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)

    walk(specs)
    assert [len(s) for s in flat] == [r.ndim for r in real]


def test_constrain_is_a_noop_without_a_mesh():
    x = torch.randn(4, 4)
    assert constrain(x, "dp", "tp") is x


def _start(code: str, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(p, timeout=300) -> str:
    out, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err[-3000:]
    return out.strip().splitlines()[-1]


_PORT_SHAPES = """
import json, torch
from repro_torch.compat import make_auto_mesh
from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import (
    init_fake_world, make_production_mesh, close_ranks)
from repro_torch.launch import specs as S
from repro_torch.sharding import NamedSharding, P
from repro_torch.tree import leaves
out = {}
for n, multi in ((256, False), (512, True)):
    init_fake_world(n)
    m = make_production_mesh(multi_pod=multi, device_type="cpu")
    out[f"mesh{n}"] = [m.size(), list(m.mesh_dim_names)]
    close_ranks()
init_fake_world(8)
mesh = make_auto_mesh((2, 4), ("data", "model"), "cpu")
for arch in %r:
    cfg = get_reduced(arch)
    out[arch] = [list(t.to_local().shape) for t in
                 leaves(S.abstract_sharded_params(cfg, mesh))]
for V in (49155, 256206, 256):
    sh = S.sanitize_sharding(NamedSharding(mesh, P("model", ("data",))),
                             (V, 64), mesh)
    out[str(V)] = list(sh.shard_shape((V, 64)))
print(json.dumps(out))
"""

_JAX_SHAPES = """
import json, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_reduced
from repro.compat import make_auto_mesh
from repro.launch import specs as S
mesh = make_auto_mesh((2, 4), ("data", "model"))
out = {}
for arch in %r:
    cfg = get_reduced(arch)
    params = S.abstract_sharded_params(cfg, mesh)
    out[arch] = [list(l.sharding.shard_shape(l.shape))
                 for l in jax.tree.leaves(params)]
for V in (49155, 256206, 256):
    sh = S.sanitize_sharding(NamedSharding(mesh, P("model", ("data",))),
                             (V, 64), mesh)
    out[str(V)] = list(sh.shard_shape((V, 64)))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def shard_shapes():
    """Local shapes from the port in a fake world of 8 and from one
    8-device JAX process (side by side), once for the module."""
    port = _start(_PORT_SHAPES % (ARCHS,))
    ref = _start(_JAX_SHAPES % (ARCHS,), {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"})
    return json.loads(_result(port)), json.loads(_result(ref))


def test_production_meshes_in_a_fake_world(shard_shapes):
    port, _ = shard_shapes
    assert port["mesh256"] == [256, ["data", "model"]]
    assert port["mesh512"] == [512, ["pod", "data", "model"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_match_jax(shard_shapes, arch):
    """Each leaf's local shape on a (2, 4) mesh is JAX's shard shape
    without the stacked leading dims (which are never sharded)."""
    port, ref = shard_shapes
    cfg = get_reduced(arch)
    ref_leaves = _expand(arch, cfg, ref[arch])
    assert len(port[arch]) == len(ref_leaves)
    for mine, theirs in zip(port[arch], ref_leaves):
        assert mine == theirs


def _expand(arch, cfg, ref_list):
    """The reference's stacked local shapes as the port's per-layer
    leaves, in the port's tree order: the weight carrier lays out
    stand-in arrays of those shapes."""
    import jax
    import numpy as np

    from repro_torch.models.convert import params_from_numpy

    treedef = jax.tree.structure(jax_api.abstract_params(jax_reduced(arch)))
    arrays = [np.zeros(s, np.float32) for s in ref_list]
    port = params_from_numpy(cfg, jax.tree.unflatten(treedef, arrays),
                             device="cpu")
    return [list(t.shape) for t in leaves(port)]


def test_sanitize_replicates_indivisible_vocab(shard_shapes):
    port, ref = shard_shapes
    for V in ("49155", "256206", "256"):
        assert port[V] == ref[V]
    assert port["49155"] == [49155, 32]    # 49155 % 4 != 0: replicated
    assert port["256"] == [64, 32]


def test_core_exports_the_reference_core_names():
    """repro_torch.core exports every name of the reference's core list
    (tests/test_api_surface.py) but the JAX-only ones, and the port's
    backend default follows env > set_default_backend > "auto"."""
    import repro.core
    import repro_torch.core as core

    missing = sorted(set(repro.core.__all__) - set(core.__all__))
    assert missing == [], missing
    assert core.default_backend() in ("auto", "ref")
    old = os.environ.pop("REPRO_TORCH_GREEDY_BACKEND", None)
    try:
        core.set_default_backend("ref")
        assert core.default_backend() == "ref"
        assert core.resolve_backend() == "ref"
        os.environ["REPRO_TORCH_GREEDY_BACKEND"] = "auto"
        assert core.resolve_backend() == "auto"
        with pytest.raises(ValueError):
            core.set_default_backend("pallas")
    finally:
        core.set_default_backend("auto")
        os.environ.pop("REPRO_TORCH_GREEDY_BACKEND", None)
        if old is not None:
            os.environ["REPRO_TORCH_GREEDY_BACKEND"] = old
