"""Rank programs of ``test_torch_dryrun.py``.

:func:`repro_torch.launch.mesh.spawn_ranks` starts each rank with
``spawn``, so a rank's function must be importable by name; these live
apart from the test module so that a rank imports PyTorch and the port
alone (no JAX).  Each returns host data.
"""

import torch


def mesh_moe_block(capacity_factors):
    """The MoE block of reduced mixtral (float32) on this rank's mesh
    path against its plain path, on the same seeded weights and input,
    for each capacity factor: on a (2, 1) mesh (groups over data) and a
    (1, 2) mesh (the experts' hidden dim over model, their partial sums
    reduced after the combine).  Returns, per (mesh, capacity factor),
    the largest absolute difference and the plain output's largest
    magnitude."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.compat import make_auto_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe
    from repro_torch.sharding import placements, resolve, sanitize, use_mesh

    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = make_auto_mesh(shape, ("data", "model"), "cpu")
        for cf in capacity_factors:
            cfg = get_reduced("mixtral-8x7b").replace(
                dtype="float32", moe_group_size=12, capacity_factor=cf)
            gen = torch.Generator().manual_seed(3)
            p = moe.init_moe(gen, cfg)
            x = torch.randn((2, 24, cfg.d_model), generator=gen)
            want = moe.moe_block(p, x, cfg)

            def dist(t, spec):
                spec = sanitize(mesh, resolve(mesh, *spec), t.shape)
                return distribute_tensor(t, mesh,
                                         placements(mesh, spec, t.ndim))

            specs = moe.moe_specs(cfg)
            pd = {k: dist(v, specs[k]) for k, v in p.items()}
            with use_mesh(mesh):
                got = moe.moe_block(pd, dist(x, ("dp", None, None)), cfg)
            got = got.full_tensor()
            out[f"{shape}-{cf}"] = (float((got - want).abs().max()),
                                    float(want.abs().max()))
    return out
