"""Scaling harness (counterpart of bench_scaling.py): rays/s at one card
and over all local cards, a CPU dry run of the host x chip path, and the
kill-one-host fault harness.

    python -m solr_tpu_torch.bench_scaling [--tris 200000] [--res 256]
        [--frames 3] [--no-fault] [--device cuda]

Several processes (one rank per card; torchrun, or
``SOLR_COORDINATOR=host:port SOLR_NUM_PROCESSES=N SOLR_PROCESS_ID=i``)
bring up the process group from the environment
(``parallel.initialize_distributed``), and the second point spans every
rank on a ('host', 'chip') mesh.  One process with several local cards
spawns one NCCL rank per card (``parallel.launch.spawn_group``) for it.

The frame is the bench scene (``bench_scene``, BLOCK 512) at ``--tris``
triangles and ``--res`` squared, 2 bounces, through ``shard_render``:
one warm-up, then the best of ``--frames`` synced frames; rays = pixels
x bounces x (1 + lights), as the reference counts them.

With one rank the multi-rank path is checked on the CPU instead: eight
gloo ranks as a 2-host x 4-chip mesh render six spheres at 32x32
through ``shard_render``, which must equal one-process ``render_sample``
(atol 1e-6), and take one ZeRO-1 ``make_sharded_train_step`` step (Adam
at 1e-2) toward the frame shifted one pixel to the right, at 0.7 of its
brightness, so that the loss and the gradients are not zero (the scene
is mirror-symmetric: a target that is too would leave the light's x
gradient at rounding noise, which Adam's first step turns into a step
of either sign).  Every rank's loss and updated parameters, and Adam's
first moment (the reduced gradient), must equal those of the same step
taken in one process (rtol 1e-4, atol 1e-6), and the step must move the
parameters; no rank touches CUDA.  Then
``python -m solr_tpu_torch.fault_injection --res 48`` runs on the same
device (``--no-fault`` skips it).

Prints one JSON line; exits 1 when the dry run or the fault harness
fails.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

__all__ = ["main"]

BLOCK = 512
BOUNCES = 2
DRYRUN_RANKS, DRYRUN_HOSTS = 8, 2
DRYRUN_RES = 32
DRYRUN_ATOL = 1e-6
DRYRUN_LR = 1e-2
DRYRUN_TARGET_SCALE = 0.7
# rtol, atol of the step's loss and parameters; the first moment is held
# to rtol of its largest element.
DRYRUN_STEP_TOL = (1e-4, 1e-6)
FAULT_RES = 48
CHILD_TIMEOUT_S = 600.0
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@torch.no_grad()
def _best_frame_s(scene, cam, cfg, mesh, frames: int) -> float:
    """One warm-up, then the best of ``frames`` frames of
    ``shard_render`` between syncs, in seconds."""
    from solr_tpu_torch.parallel import shard_render

    img = shard_render(scene, cam, cfg, mesh)[0]
    if not torch.isfinite(img).all():
        raise AssertionError("a non-finite frame")
    best = float("inf")
    for _ in range(frames):
        _sync(scene.device)
        t0 = time.perf_counter()
        shard_render(scene, cam, cfg, mesh)
        _sync(scene.device)
        best = min(best, time.perf_counter() - t0)
    return best


def _frame(n_tris, res, device):
    from solr_tpu_torch.bench_scene import bench_scene

    scene, cam, cfg = bench_scene(n_tris, block=BLOCK, width=res, height=res,
                                  bounces=BOUNCES, device=device)
    n_lights = scene.lights.position.shape[0]
    rays = cfg.n_pixels * cfg.max_bounces * (1 + n_lights)
    return scene, cam, cfg, rays


def _spread_rank(rank, world, n_tris, res, frames, device):
    """One rank of the point over every local card: its rays/s over a
    mesh of all ranks."""
    from solr_tpu_torch.parallel import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    scene, cam, cfg, rays = _frame(n_tris, res, dev)
    return rays / _best_frame_s(scene, cam, cfg, make_mesh(
        device_type=dev.type), frames)


def _measure(n_tris: int = 200_000, res: int = 256, frames: int = 3,
             device="cuda", local_ranks=None) -> dict:
    """Rays/s of ``shard_render`` on a one-rank mesh, with the kernel
    launches of its frames, and over every rank of the job or, in one
    process, over ``local_ranks`` spawned ranks (every local card by
    default) with their efficiency against linear."""
    from solr_tpu_torch.ops import bvh, sweep
    from solr_tpu_torch.parallel import (initialize_distributed,
                                         make_host_chip_mesh, make_mesh)
    from solr_tpu_torch.parallel.launch import spawn_group

    device = torch.device(device)
    info = initialize_distributed(device=device)
    world = info["process_count"]
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    scene, cam, cfg, rays = _frame(n_tris, res, device)
    one = None if world == 1 else make_mesh(1, device_type=device.type)
    points = []
    if info["process_index"] == 0:
        for counts in (sweep.LAUNCHES, bvh.LAUNCHES):
            counts.update(dict.fromkeys(counts, 0))
        r1 = rays / _best_frame_s(scene, cam, cfg, one, frames)
        points.append({"devices": 1, "label": "1 device",
                       "rays_per_s": round(r1), "launches": {
                           k: v for k, v in {**sweep.LAUNCHES,
                                             **bvh.LAUNCHES}.items() if v}})
    if world > 1:  # several processes: every rank, host-major
        mesh = make_host_chip_mesh(device_type=device.type)
        hosts = mesh.mesh.shape[0]
        rn, n = rays / _best_frame_s(scene, cam, cfg, mesh, frames), world
    else:
        n = local_ranks
        if n is None:
            n = torch.cuda.device_count() if device.type == "cuda" else 1
        if n > 1:
            backend = "nccl" if device.type == "cuda" else "gloo"
            rn = spawn_group(_spread_rank, n, args=(n_tris, res, frames,
                                                    device.type),
                             backend=backend, device=device.type,
                             timeout_s=CHILD_TIMEOUT_S).join()[0]
        hosts = 1
    if n > 1 and points:
        points.append({
            "devices": n, "label": f"{hosts} hosts" if hosts > 1 else "1 host",
            "rays_per_s": round(rn),
            "efficiency_vs_linear": round(rn / (points[0]["rays_per_s"] * n),
                                          4)})
    return {"points": points, "process_info": info,
            "config": f"{scene.triangles.v0.shape[0]} tris {res}^2 "
                      f"{cfg.max_bounces}b",
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}


def _dryrun_frame():
    """The dry run's scene, camera and config (six spheres at 32x32, 2
    bounces, on the CPU), its frame and the train step's target: the
    frame shifted one pixel to the right, at DRYRUN_TARGET_SCALE of its
    brightness."""
    from solr_tpu_torch.ops.render import render_sample
    from solr_tpu_torch.scene import SceneBuilder
    from solr_tpu_torch.types import Camera, RenderConfig

    b = SceneBuilder()
    m = b.add_material(color=(0.7, 0.3, 0.2, 1.0))
    for i in range(6):
        b.add_sphere((i - 2.5, 0.0, 3.0), 0.5, m)
    b.add_light((0, 5, 0))
    scene = b.build(device="cpu")
    cam = Camera.create(device="cpu")
    cfg = RenderConfig(width=DRYRUN_RES, height=DRYRUN_RES,
                       max_bounces=BOUNCES)
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0]
    target = torch.roll(img[..., :3], 1, dims=1) * DRYRUN_TARGET_SCALE
    return scene, cam, cfg, img, target


def _dryrun_rank(rank, world, n_hosts):
    """One CPU rank of the dry run: (frame equal to the one-process
    frame, the train step's loss, the flat parameters after it, this
    rank's shard index and its shard of Adam's first moment (a tenth of
    the reduced gradient), whether CUDA was initialised)."""
    from solr_tpu_torch.parallel import (init_zero_opt_state,
                                         make_host_chip_mesh,
                                         make_sharded_train_step,
                                         shard_render)
    from solr_tpu_torch.parallel.grads import flatten_params
    from solr_tpu_torch.parallel.mesh import linear_index

    torch.set_num_threads(1)
    scene, cam, cfg, img_1, target = _dryrun_frame()
    mesh = make_host_chip_mesh(n_hosts=n_hosts, device_type="cpu")
    with torch.no_grad():
        img_s = shard_render(scene, cam, cfg, mesh)[0]
    equal = bool(torch.allclose(img_s, img_1, rtol=0.0, atol=DRYRUN_ATOL))
    step, opt = make_sharded_train_step(
        scene, cam, cfg, mesh,
        functools.partial(torch.optim.Adam, lr=DRYRUN_LR),
        grad_reduce="reduce_scatter")
    state = init_zero_opt_state(scene, opt, mesh)
    params = {k: tuple(x.clone() for x in v) if isinstance(v, tuple)
              else v.clone() for k, v in scene.params.items()}
    _, _, loss = step(params, state, target)
    (shard,) = state.param_groups[0]["params"]
    return (equal, float(loss), flatten_params(params, 1)[0].numpy(),
            (linear_index(mesh), state.state[shard]["exp_avg"].numpy()),
            torch.cuda.is_initialized())


def _one_process_step():
    """The dry run's train step in one process: the whole frame's mean
    squared error and one Adam step (DRYRUN_LR) on every parameter.
    Returns (loss, flat parameters before, after, Adam's first
    moment)."""
    from solr_tpu_torch.ops.render import render_sample
    from solr_tpu_torch.parallel.grads import flatten_params, unflatten_params

    scene, cam, cfg, _, target = _dryrun_frame()
    flat, spec = flatten_params(scene.params, 1)
    before = flat.detach().clone()
    flat = before.clone().requires_grad_()
    img = render_sample(scene.with_params(unflatten_params(flat, spec)), cam,
                        cfg)[0]
    loss = ((img[..., :3] - target) ** 2).mean()
    loss.backward()
    opt = torch.optim.Adam([flat], lr=DRYRUN_LR)
    opt.step()
    return (float(loss.detach()), before.numpy(), flat.detach().numpy(),
            opt.state[flat]["exp_avg"].numpy())


def _cpu_mesh_dryrun(ranks: int = DRYRUN_RANKS,
                     n_hosts: int = DRYRUN_HOSTS) -> dict:
    """The host x chip path on ``ranks`` spawned gloo ranks on the CPU
    (``n_hosts`` hosts); ``host_chip_dryrun_ok`` when every rank's
    frame equals the one-process frame, every rank's loss and updated
    parameters, and the ranks' shards of Adam's first moment (which a
    wrong gradient reduction moves, even where the first step's update,
    lr times the gradient's sign, does not), equal the one-process
    step's; that step moved the parameters; and no rank initialised
    CUDA."""
    from solr_tpu_torch.parallel.launch import spawn_group

    t0 = time.perf_counter()
    out = spawn_group(_dryrun_rank, ranks, args=(n_hosts,), backend="gloo",
                      device="cpu", timeout_s=CHILD_TIMEOUT_S).join()
    loss_1, before, after, moment_1 = _one_process_step()
    rtol, atol = DRYRUN_STEP_TOL
    params_equal = [bool(np.allclose(p, after, rtol=rtol, atol=atol))
                    for _, _, p, _, _ in out]
    losses_equal = [bool(np.isclose(loss, loss_1, rtol=rtol, atol=0.0))
                    for _, loss, _, _, _ in out]
    # The ZeRO-1 shards of the first moment, in mesh order, less padding.
    moment = np.concatenate([m for _, m in sorted(
        (r[3] for r in out), key=lambda r: r[0])])[:moment_1.shape[0]]
    moment_err = float(np.abs(moment - moment_1).max()
                       / np.abs(moment_1).max())
    moved = float(np.abs(after - before).max())
    ok = (loss_1 > 0.0 and moved > 0.0 and moment_err <= rtol
          and all(params_equal) and all(losses_equal)
          and all(eq and not cuda for eq, _, _, _, cuda in out))
    return {"host_chip_dryrun_ok": ok, "devices": ranks, "hosts": n_hosts,
            "frames_equal": [r[0] for r in out],
            "loss": out[0][1], "loss_one_process": loss_1,
            "losses_equal": losses_equal, "params_equal": params_equal,
            "params_max_abs_err": max(float(np.abs(r[2] - after).max())
                                      for r in out),
            "params_moved": moved,
            "moment_max_rel_err": moment_err,
            "cuda_touched": any(r[4] for r in out),
            "seconds": time.perf_counter() - t0}


def _child(argv, **env):
    """The last stdout line of ``python -m *argv`` (with ``env`` added to
    the environment) as JSON, or the error.  The child runs in a session
    of its own, so that one past its time limit is ended with every
    process it started."""
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **env)
    child = subprocess.Popen([sys.executable, "-m", *argv], env=env,
                             stdout=subprocess.PIPE, text=True,
                             start_new_session=True)
    try:
        stdout, _ = child.communicate(timeout=CHILD_TIMEOUT_S)
        rec = json.loads(stdout.strip().splitlines()[-1])
        rec["exit_code"] = child.returncode
        return rec
    except (subprocess.TimeoutExpired, IndexError, ValueError) as e:
        return {"error": f"{type(e).__name__}: {str(e)[:300]}",
                "exit_code": child.returncode}
    finally:
        if child.poll() is None:
            os.killpg(child.pid, signal.SIGKILL)
            child.communicate()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tris", type=int, default=200_000)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--no-fault", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dryrun_child:
        print(json.dumps(_cpu_mesh_dryrun()), flush=True)
        return 0
    result = _measure(args.tris, args.res, args.frames, args.device)
    if result["process_info"]["process_index"] != 0:
        return 0
    ok = True
    if len(result["points"]) == 1:  # one rank: the multi-rank path on CPUs
        t0 = time.perf_counter()
        result["virtual_multihost"] = vm = _child(
            ["solr_tpu_torch.bench_scaling", "--dryrun-child"],
            CUDA_VISIBLE_DEVICES="")  # the dry run touches no card
        vm["child_s"] = time.perf_counter() - t0
        ok = vm.get("host_chip_dryrun_ok") is True
    if not args.no_fault:
        t0 = time.perf_counter()
        result["fault_injection"] = fi = _child(
            ["solr_tpu_torch.fault_injection", "--res", str(FAULT_RES),
             "--device", args.device])
        fi["child_s"] = time.perf_counter() - t0
        ok = ok and fi.get("exit_code") == 0 and all(
            fi.get(k) is True for k in ("fault_injection_ok",
                                        "bit_identical_to_uninterrupted",
                                        "work_preserved"))
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
