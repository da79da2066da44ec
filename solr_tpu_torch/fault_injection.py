"""Kill-one-host fault-injection harness (counterpart of
tools/fault_injection.py).

    python -m solr_tpu_torch.fault_injection [--device cuda] [--res 64]

Two "hosts" render one frame as two contiguous row bands (the unit
``parallel.render`` shards over), each band resumable in 8-row chunks
(``utils.resumable.resumable_render``, with its heartbeat).  The
supervisor

  1. renders an uninterrupted reference run, one worker per host;
  2. starts a fault run in which host 1 is slow, and SIGKILLs it 0.6 s
     after its first heartbeat;
  3. detects the stall (the heartbeat older than STALL_S), reads the
     newest checkpoint and relaunches the host, which resumes there:
     completed chunks are never rendered again;
  4. gathers the bands: the frame must be bit-identical to the
     uninterrupted run.

Workers are fresh interpreters (``python -m
solr_tpu_torch.fault_injection --worker ...``), never forks of a process
that touched CUDA.  Prints one JSON line (the reference's keys, the
count of chunks the relaunched host rendered again, and
``pixels_differing_from_one_shot``: the pixels that differ at all from
``render_sample`` of the whole frame on the same device, ROADMAP C13);
exits 1 unless the frame is bit-identical and the work was preserved.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

__all__ = ["fault_scene", "supervise", "main"]

N_HOSTS = 2
ROWS_PER_CHUNK = 8
SLOW_CHUNK_S = 0.4  # the slow host's pause after each chunk
KILL_AFTER_S = 0.6  # after the slow host's first heartbeat
STALL_S = 3.0  # a heartbeat older than this is a dead host
WORKER_TIMEOUT_S = 300.0
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fault_scene(res: int, device="cuda"):
    """(scene, camera, config) of the harness (tools/fault_injection.py
    :50-67): five spheres, mirror and diffuse in turn, over a floor
    plane, one light, 2 bounces, res x res."""
    from solr_tpu_torch.scene import SceneBuilder
    from solr_tpu_torch.types import Camera, PlaneAxis, RenderConfig

    b = SceneBuilder()
    m = b.add_material(color=(0.7, 0.4, 0.2, 1.0), specular=0.3)
    mirror = b.add_material(color=(0.9, 0.9, 0.9, 1.0), reflection=0.5)
    floor = b.add_material(color=(0.5, 0.5, 0.55, 1.0))
    b.add_plane(PlaneAxis.XZ, (0.0, -1.0, 0.0), (10.0, 10.0), floor)
    for i in range(5):
        b.add_sphere((i - 2.0, 0.0, 2.0 + (i % 2)), 0.5,
                     m if i % 2 else mirror)
    b.add_light((0.0, 6.0, -2.0), intensity=1.0)
    cam = Camera.create(position=(0.0, 0.8, -4.0), angles=(0.15, 0.0, 0.0),
                        fov=1.0, device=device)
    cfg = RenderConfig(width=res, height=res, max_bounces=2)
    return b.build(device=device), cam, cfg


def worker(host_id: int, workdir: str, res: int, device: str, slow: bool):
    """One host: its row band through resumable_render, resuming from
    its checkpoints; each finished chunk is logged to
    ``events_{host_id}`` and the band saved as ``band_{host_id}.npy``."""
    from solr_tpu_torch.utils.resumable import resumable_render

    scene, cam, cfg = fault_scene(res, device)
    band = res // N_HOSTS
    events = os.path.join(workdir, f"events_{host_id}")

    def log(event, **fields):
        with open(events, "a") as f:
            f.write(json.dumps(dict(event=event, pid=os.getpid(), **fields))
                    + "\n")

    img, _ = resumable_render(
        scene, cam, cfg, os.path.join(workdir, f"ckpt_host{host_id}"),
        rows_per_chunk=ROWS_PER_CHUNK, row0=host_id * band, n_rows=band,
        heartbeat=os.path.join(workdir, f"heartbeat_{host_id}"),
        chunk_sleep_s=SLOW_CHUNK_S if slow else 0.0, log=log)
    np.save(os.path.join(workdir, f"band_{host_id}.npy"), img.cpu().numpy())


class _Hosts:
    """The worker processes of one supervisor; ``close`` kills any still
    running."""

    def __init__(self, res: int, device: str):
        self.res, self.device, self.procs = res, device, []
        path = os.environ.get("PYTHONPATH")
        self.env = dict(os.environ, PYTHONPATH=_REPO if not path
                        else _REPO + os.pathsep + path)

    def launch(self, host_id: int, workdir: str, slow: bool = False):
        p = subprocess.Popen(
            [sys.executable, "-m", "solr_tpu_torch.fault_injection",
             "--worker", str(host_id), workdir, "--res", str(self.res),
             "--device", self.device] + (["--slow"] if slow else []),
            env=self.env)
        self.procs.append(p)
        return p

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _wait_all(procs):
    for h, p in procs.items():
        rc = p.wait(timeout=WORKER_TIMEOUT_S)
        if rc != 0:
            raise RuntimeError(f"host {h} exited with {rc}")


def _frame(workdir):
    return np.concatenate([np.load(os.path.join(workdir, f"band_{h}.npy"))
                           for h in range(N_HOSTS)])


def supervise(workdir: str, res: int = 64, device: str = "cuda",
              kill_host: int = 1) -> dict:
    """Run the reference and the fault run in ``workdir``; returns the
    result record."""
    from solr_tpu_torch.ops.render import render_sample
    from solr_tpu_torch.utils.checkpoint import latest_step
    from solr_tpu_torch.utils.resumable import heartbeat_age

    if res % (N_HOSTS * ROWS_PER_CHUNK):
        raise ValueError(f"--res {res} is no whole number of "
                         f"{ROWS_PER_CHUNK}-row chunks per host")
    hosts = _Hosts(res, device)
    try:
        refdir = os.path.join(workdir, "ref")
        os.makedirs(refdir, exist_ok=True)
        _wait_all({h: hosts.launch(h, refdir) for h in range(N_HOSTS)})

        procs = {h: hosts.launch(h, workdir, slow=h == kill_host)
                 for h in range(N_HOSTS)}
        hb = os.path.join(workdir, f"heartbeat_{kill_host}")
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        while not os.path.exists(hb):
            if procs[kill_host].poll() is not None:
                raise RuntimeError(f"host {kill_host} exited with "
                                   f"{procs[kill_host].returncode} before "
                                   "its first heartbeat")
            if time.monotonic() > deadline:
                raise RuntimeError("the slow host never sent a heartbeat")
            time.sleep(0.1)
        time.sleep(KILL_AFTER_S)
        procs[kill_host].send_signal(signal.SIGKILL)
        procs[kill_host].wait()
        kill_t = time.monotonic()

        while True:  # failure detection: the heartbeat stops advancing
            age = heartbeat_age(hb)
            if age is not None and age > STALL_S:
                break
            if time.monotonic() - kill_t > 60:
                raise RuntimeError("the stall was never detected")
            time.sleep(0.2)
        detect_s = time.monotonic() - kill_t
        resumed_from = latest_step(
            os.path.join(workdir, f"ckpt_host{kill_host}")) or 0

        procs[kill_host] = hosts.launch(kill_host, workdir)  # fast now
        _wait_all(procs)
    finally:
        hosts.close()

    with open(os.path.join(workdir, f"events_{kill_host}")) as f:
        events = [json.loads(line) for line in f]
    last_pid = procs[kill_host].pid
    rerendered = sum(e["event"] == "chunk_done" and e["pid"] == last_pid
                     and e["chunk"] < resumed_from for e in events)
    fault_img, ref_img = _frame(workdir), _frame(refdir)
    identical = bool(np.array_equal(fault_img, ref_img))
    scene, cam, cfg = fault_scene(res, device)
    one_shot = render_sample(scene, cam, cfg)[0].cpu().numpy()
    result = {
        "fault_injection_ok": identical,
        "killed_host": kill_host,
        "detect_s": round(detect_s, 2),
        "resumed_from_chunk": int(resumed_from),
        "chunks_per_host": res // N_HOSTS // ROWS_PER_CHUNK,
        "work_preserved": bool(resumed_from > 0 and rerendered == 0),
        "bit_identical_to_uninterrupted": identical,
        "chunks_rendered_again": rerendered,
        "pixels_differing_from_one_shot": int(
            (fault_img != one_shot).any(-1).sum()),
        "res": res,
        "device": device,
    }
    if not identical:
        result["max_abs_diff"] = float(np.abs(fault_img - ref_img).max())
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--worker", nargs=2, metavar=("HOST", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--slow", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(int(args.worker[0]), args.worker[1], args.res, args.device,
               args.slow)
        return 0
    with tempfile.TemporaryDirectory(prefix="solr_fault_") as workdir:
        result = supervise(workdir, args.res, args.device)
    print(json.dumps(result), flush=True)
    return 0 if result["fault_injection_ok"] and result["work_preserved"] \
        else 1


if __name__ == "__main__":
    sys.exit(main())
