"""Rank functions for tests/test_torch_parallel.py and
tests/test_torch_gpu.py, run on spawned ranks by
``solr_tpu_torch.parallel.launch.spawn_group``.

Spawned ranks import this module, so it imports no JAX at module level
(it runs where only PyTorch is installed); only the keyed scenario,
which replays ``jax.random`` through ``JaxKey``, imports JAX inside a
rank.  Each function returns numpy arrays and plain values.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from solr_tpu_torch.convert import camera_from_numpy, scene_from_numpy
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.parallel import (broadcast_scene, init_zero_opt_state,
                                     make_host_chip_mesh, make_mesh,
                                     make_sharded_train_step, shard_render,
                                     sharded_loss_grad)
from solr_tpu_torch.parallel.ring import ring_closest_hit


def np_tree(tree):
    """A tree of dicts and tuples of tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(np_tree(v) for v in tree)
    return tree.detach().cpu().numpy()


def _port(case, dtype=torch.float32):
    """(scene, camera) of a case: the reference's scene flattened to
    numpy (``scene``, float leaves in ``dtype``, info in ``info_dtype``)
    and camera."""
    scene = scene_from_numpy(case["scene"], "cpu", dtype)
    if case.get("info_dtype") is not None:
        scene = scene.replace(info=scene_from_numpy(
            case["scene"], "cpu", case["info_dtype"]).info)
    return scene, camera_from_numpy(case["camera"], "cpu", dtype)


def _frame(scene, cam, cfg, mesh, key=None):
    img, depth = shard_render(scene, cam, cfg, mesh, key)
    return img.numpy(), depth.numpy()


def cpu_scenarios(rank, world, cases):
    """Every CPU scenario of one group (gloo, CPU tensors, one thread),
    keyed by name; scenarios a world skips are absent."""
    torch.set_num_threads(1)
    mesh = make_mesh(device_type="cpu")
    out = {}
    scene, cam = _port(cases["cornell"])
    cfg = cases["cfg"]
    # Rank 0 holds the scene; the others receive it.
    got = broadcast_scene(scene if rank == 0 else None, 0, mesh,
                          device="cpu")
    out["broadcast_equal"] = all(
        torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(scene)))
    out["render"] = _frame(scene, cam, cfg, mesh)

    try:
        shard_render(scene, cam, cases["odd_cfg"], mesh)
        out["indivisible"] = "no error"
    except ValueError as e:
        out["indivisible"] = str(e)
    dist.barrier()  # every rank is still in step after the error

    f64, cam64 = _port(cases["cornell64"], torch.float64)
    target = torch.as_tensor(cases["target64"])
    for mode in ("psum", "reduce_scatter"):
        loss, grads = sharded_loss_grad(f64, cam64, cfg, target, mesh, mode)
        out[f"grads_{mode}"] = (float(loss), np_tree(grads))
    if world < 4:
        return out

    sub = make_mesh(2, device_type="cpu")
    out["render_sub"] = (_frame(scene, cam, cfg, sub) if rank < 2 else None)
    hc = make_host_chip_mesh(n_hosts=2, device_type="cpu")
    out["host_chip_axes"] = hc.mesh_dim_names
    out["host_chip_render"] = _frame(scene, cam, cfg, hc)
    loss, grads = sharded_loss_grad(f64, cam64, cfg, target, hc)
    out["host_chip_grads"] = (float(loss), np_tree(grads))

    out["zero"] = _zero_vs_psum(scene, cam, cfg,
                                torch.as_tensor(cases["target"]), mesh)
    out["train"] = _train_albedo(scene, cam, cfg,
                                 torch.as_tensor(cases["target"]), mesh)

    tri = scene_from_numpy(cases["tri_field"], "cpu")
    o, d = (torch.as_tensor(cases["rays"][k]) for k in ("o", "d"))
    t, i = ring_closest_hit(tri, o, d, mesh)
    out["ring"] = (t.numpy(), i.numpy())

    from torch_rng_helpers import JaxKey  # the keyed frames replay jax

    lens = camera_from_numpy(cases["lens_camera"], "cpu")
    for name in ("side_by_side", "anaglyph"):
        out[f"keyed_{name}"] = _frame(scene, lens, cases[f"{name}_cfg"],
                                      mesh, JaxKey(cases["key_seed"]))
    return out


def _leaves(tree):
    import dataclasses

    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _clone_params(scene):
    return {k: tuple(x.clone() for x in v) if isinstance(v, tuple)
            else v.clone() for k, v in scene.params.items()}


def _zero_vs_psum(scene, cam, cfg, target, mesh, steps=3):
    """Three train steps with the optimizer replicated (psum) and
    sharded (ZeRO-1): (losses, params) of each."""
    opt = functools.partial(torch.optim.Adam, lr=1e-2)
    runs = {}
    for mode in ("psum", "reduce_scatter"):
        step, opt = make_sharded_train_step(scene, cam, cfg, mesh, opt, mode)
        params = _clone_params(scene)
        state = (init_zero_opt_state(scene, opt, mesh) if mode != "psum"
                 else opt([x for v in params.values()
                           for x in (v if isinstance(v, tuple) else (v,))]))
        losses = []
        for _ in range(steps):
            params, state, loss = step(params, state, target)
            losses.append(float(loss))
        runs[mode] = (losses, np_tree(params))
    return runs


def _train_albedo(scene, cam, cfg, target, mesh, steps=41):
    """An albedo-only recovery (the reference's masked optimizer is an
    optimizer over the albedo tensor): the first and last loss."""
    step, opt = make_sharded_train_step(scene, cam, cfg, mesh)
    params = _clone_params(scene)
    params["albedo"] = params["albedo"] + 0.1
    state = opt([params["albedo"]])
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, target)
        losses.append(float(loss))
    return losses[0], losses[-1]


def gpu_frame(rank, world, n_tris, block, cfg):
    """The bench frame on the card at ``cfg``, sharded over the ranks
    (gloo, all sharing cuda:0): rank 0 builds the scene and camera and
    broadcasts them; returns (image, this rank's B1 and B2 launches)."""
    from solr_tpu_torch.bench_scene import bench_scene

    device = torch.device("cuda:0")
    mesh = make_mesh(device_type="cuda")
    scene = cam = None
    if rank == 0:
        scene, cam, _ = bench_scene(n_tris, block=block, width=cfg.width,
                                    height=cfg.height,
                                    bounces=cfg.max_bounces, device=device)
    scene = broadcast_scene(scene, 0, mesh, device)
    cam = broadcast_scene(cam, 0, mesh, device)
    for k in sweep.LAUNCHES:
        sweep.LAUNCHES[k] = 0
    with torch.no_grad():
        img, _ = shard_render(scene, cam, cfg, mesh)
    return img.cpu().numpy(), dict(sweep.LAUNCHES)
