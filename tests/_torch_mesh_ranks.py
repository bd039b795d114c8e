"""Rank programs of ``test_torch_dryrun.py``, ``test_torch_tp_modes.py``
and ``test_torch_pipeline.py``.

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


TP_MODES = (("megatron", {}), ("ulysses", {"tp_mode": "ulysses"}),
            ("megatron_rs", {"tp_mode": "megatron_rs"}),
            ("ulysses+ep", {"tp_mode": "ulysses", "moe_ep": True}))


def _dist_batch(batch, mesh):
    """Numpy tokens and labels (B, S) as DTensors split over dp."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding import placements, resolve

    pl = placements(mesh, resolve(mesh, "dp", None), 2)
    return {k: distribute_tensor(torch.from_numpy(v), mesh, pl,
                                 src_data_rank=None)
            for k, v in batch.items()}


def _helpers(mesh):
    """Each manual TP region of ``repro_torch.sharding`` against its plain
    product on the same float32 values: the output and the gradients of a
    random linear functional of it, as the largest absolute differences
    and the plain values' largest magnitude."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import sharding as sh

    gen = torch.Generator().manual_seed(7)
    x, h = torch.randn(4, 8, 6, generator=gen), torch.randn(
        4, 8, 10, generator=gen)
    w_in, w_out = torch.randn(6, 10, generator=gen), torch.randn(
        10, 6, generator=gen)
    seq, hid = ("dp", "sp", None), ("dp", None, "tp")
    cases = {
        "seq_allgather": (lambda a, w: sh.seq_allgather(a),
                          lambda a, w: a, x, w_in, seq, ("fsdp", "tp")),
        "tp_ag_matmuls": (lambda a, w: sh.tp_ag_matmuls(a, w)[0],
                          lambda a, w: a @ w, x, w_in, seq, ("fsdp", "tp")),
        "tp_rs_matmul": (sh.tp_rs_matmul, lambda a, w: a @ w, h, w_out, hid,
                         ("tp", "fsdp")),
        "seq_matmuls": (lambda a, w: sh.seq_matmuls(a, w)[0],
                        lambda a, w: a @ w, x, w_in, seq, ("fsdp", "tp")),
    }
    out = {}
    for name, (fn, plain, a, w, sa, sw) in cases.items():
        c = torch.randn(plain(a, w).shape, generator=gen)
        a0, w0 = a.clone().requires_grad_(), w.clone().requires_grad_()
        y0 = plain(a0, w0)
        g0 = torch.autograd.grad((y0 * c).sum(), [a0, w0],
                                 allow_unused=True)
        da, dw = (distribute_tensor(
            t, mesh, sh.placements(mesh, sh.resolve(mesh, *spec), t.ndim),
            src_data_rank=None).requires_grad_()
            for t, spec in ((a, sa), (w, sw)))
        with sh.use_mesh(mesh):
            y = fn(da, dw)
            g = torch.autograd.grad((y * c).sum(), [da, dw],
                                    allow_unused=True)
        diffs = [float((y.full_tensor() - y0).abs().max())]
        scale = [float(y0.abs().max())]
        for gi, g0i in zip(g, g0):
            if g0i is None:
                continue
            diffs.append(float((gi.full_tensor() - g0i).abs().max()))
            scale.append(float(g0i.abs().max()))
        out[name] = (diffs, scale)
    return out


def tp_modes(cases, bf16_seed):
    """Each mode of ``TP_MODES`` on a (2, 2) ("data", "model") mesh, for
    each ``arch: (cfg overrides, float32 port parameters, numpy batch)``
    of ``cases``: the float32 loss and every parameter's gradient
    (``api.loss_fn`` by the trainer's ``value_and_grad``, the gradients
    gathered whole, in the tree's leaf order), and the loss in bfloat16
    on parameters drawn by the port from ``bf16_seed``; each manual TP
    region against its plain product (:func:`_helpers`); then the first
    arch's megatron loss and gradients again with the functional
    all-gather routed through c10d's call
    (``launch.mesh.route_functional_all_gather``, as gloo ranks on a card
    run it); and its megatron_rs gradients with the backward on another
    thread (:func:`_backward_in_a_thread`).  Returns, on every rank,
    {"modes": {arch: {mode: {"loss", "loss_bf16", "grads" (rank 0
    only)}}}, "helpers", "threaded", "routed"}."""
    import torch.distributed as dist

    from repro_torch.compat import make_auto_mesh
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import route_functional_all_gather
    from repro_torch.launch.specs import distribute_params
    from repro_torch.models import api
    from repro_torch.sharding import use_mesh
    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree import leaves

    mesh = make_auto_mesh((2, 2), ("data", "model"), "cpu")

    def run(cfg, params, batch):
        dparams = distribute_params(cfg, params, mesh)
        with use_mesh(mesh):
            loss, grads = value_and_grad(cfg, dparams,
                                         _dist_batch(batch, mesh))
            grads = [g.full_tensor().numpy() for g in leaves(grads)]
        return float(loss.full_tensor()), grads

    out = {"modes": {}, "helpers": _helpers(mesh)}
    for arch, (over, params, batch) in cases.items():
        modes = out["modes"][arch] = {}
        base = get_reduced(arch).replace(**over)
        bf16 = base.replace(dtype="bfloat16")
        bf16_params = api.init_params(bf16, bf16_seed, device="cpu")
        for mode, ov in TP_MODES:
            loss, grads = run(base.replace(**ov), params, batch)
            bcfg = bf16.replace(**ov)
            with use_mesh(mesh), torch.no_grad():
                loss_bf16 = api.loss_fn(
                    bcfg, distribute_params(bcfg, bf16_params, mesh),
                    _dist_batch(batch, mesh))
            modes[mode] = {"loss": loss,
                           "loss_bf16": float(loss_bf16.full_tensor())}
            if dist.get_rank() == 0:
                modes[mode]["grads"] = grads
    arch, (over, params, batch) = next(iter(cases.items()))
    cfg = get_reduced(arch).replace(tp_mode="megatron_rs", **over)
    out["threaded"] = _backward_in_a_thread(cfg, params, batch, mesh)
    route_functional_all_gather("CPU")
    loss, grads = run(get_reduced(arch).replace(**over), params, batch)
    out["routed"] = {"arch": arch, "loss": loss,
                     "grads": grads if dist.get_rank() == 0 else None}
    return out


def _backward_in_a_thread(cfg, params, batch, mesh):
    """The loss's gradients (rank 0: numpy leaves) taken on a thread of
    its own while this one stays inside ``use_mesh``, as the autograd
    engine runs a CUDA backward: DTensor's implicit replication is on in
    that thread (the engine carries it there), the port's thread-local
    mesh is not, and the remat recomputation has to find the forward's
    mesh all the same."""
    import threading

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.specs import distribute_params
    from repro_torch.models import api
    from repro_torch.sharding import use_mesh
    from repro_torch.tree import leaves, unflatten

    dparams = distribute_params(cfg, params, mesh)
    got = {}

    def backward(loss, views):
        try:
            with implicit_replication():
                got["grads"] = torch.autograd.grad(loss, views)
        except Exception as e:      # reported to the test, not raised here
            got["error"] = repr(e)[:500]

    with use_mesh(mesh), torch.enable_grad():
        views = [t.detach().requires_grad_() for t in leaves(dparams)]
        loss = api.loss_fn(cfg, unflatten(dparams, views),
                           _dist_batch(batch, mesh))
        worker = threading.Thread(target=backward, args=(loss, views))
        worker.start()
        worker.join(timeout=300)
    if "error" in got:
        return {"error": got["error"]}
    grads = [g.full_tensor().numpy() for g in got["grads"]]
    return {"grads": grads if dist.get_rank() == 0 else None}


def pipeline_losses(cfg_over, params, tokens, labels, meshes):
    """The pipelined loss of reduced stablelm-3b (``cfg_over``) and its
    gradients on each mesh of ``meshes`` (``(ranks, shape, names)`` with
    a "pod" axis: a mesh over the first ``ranks`` ranks of the world): the
    embedding table's and each of this rank's stage's block leaves' (numpy,
    in the stage's leaf order).  Returns a list with, per mesh, None where
    this rank is not on it, else {"loss", "stage", "embed_grad",
    "block_grads", "shifts"}."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_reduced
    from repro_torch.training.pipeline import (
        make_pipeline_forward, stage_blocks,
    )
    from repro_torch.tree import leaves, unflatten

    cfg = get_reduced("stablelm-3b").replace(**cfg_over)
    n_micro = tokens.shape[0]
    out = []
    for n, shape, names in meshes:
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                          mesh_dim_names=names)
        if dist.get_rank() >= n:
            out.append(None)
            continue
        loss_fn, _ = make_pipeline_forward(cfg, mesh, n_micro)
        n_stages = mesh.size(names.index("pod"))
        stage = loss_fn.link.stage
        own = stage_blocks(params.blocks, n_stages)[stage]
        with torch.enable_grad():
            embed = params.embed.detach().requires_grad_()
            views = [t.detach().requires_grad_() for t in leaves(own)]
            blocks = [None] * n_stages
            blocks[stage] = unflatten(own, views)
            loss = loss_fn(embed, blocks, params.final_norm, params.lm_head,
                           torch.from_numpy(tokens),
                           torch.from_numpy(labels))
            grads = torch.autograd.grad(loss, [embed, *views])
        out.append({"loss": float(loss.detach()), "stage": stage,
                    "embed_grad": grads[0].numpy(),
                    "block_grads": [g.numpy() for g in grads[1:]],
                    "shifts": loss_fn.link.calls})
    return out
