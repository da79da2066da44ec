"""What a cell times: the program through its public API, or the plain
reference put in its place (the control, and the faults of the tests).

A frame system is made with the run's seed, which keys the frames of a
keyed cell, and has ``frame()`` -> image (H, W, >= 3); a gradient system
has ``leaves`` (name -> tensor), ``step()`` -> loss (a float: the step
ends in a sync), ``lr`` and ``kept`` (None, or a dict that the next
steps fill with their gradients).  Both have ``build_s``, ``counters()``,
``reset_counters()`` and ``close()``.
"""

from __future__ import annotations

import time

import torch

from solbench.reference import render as ref

# The gradient leaves: the program's parameter and the reference's field.
LEAVES = {"v0": "tri_v0", "v1": "tri_v1", "v2": "tri_v2",
          "sphere_center": "sph_center", "sphere_radius": "sph_radius",
          "albedo": "mat_color", "light_position": "light_position"}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_target(workload: dict, seed: int, device):
    """The gradient cell's target image (H, W, 3): uniform noise on a
    ``target_grid``^2 grid drawn on the device from ``seed``, bilinearly
    upsampled."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = workload["target_grid"]
    low = torch.rand((1, 3, n, n), generator=g, device=device)
    img = torch.nn.functional.interpolate(
        low, size=(workload["height"], workload["width"]), mode="bilinear",
        align_corners=False)
    return img[0].permute(1, 2, 0).contiguous()


@torch.no_grad()
def _descend(system):
    """Plain gradient descent on ``system.leaves``; a leaf the loss does
    not reach keeps its value.  With ``system.kept`` a dict, the
    gradients are kept there first (the first steps, which the check
    follows)."""
    for name, t in system.leaves.items():
        if system.kept is not None:
            system.kept[name] = (torch.zeros_like(t) if t.grad is None
                                 else t.grad.detach().clone())
        if t.grad is not None:
            t -= system.lr * t.grad
            t.grad = None


def render_config(cell):
    """The program's RenderConfig of ``cell``: the workload's size,
    bounces and traversal, the configuration's background and packet
    fields, and its ``render`` block (``camera_mode`` and ``postfx`` by
    enum name, ``postfx_samples`` the pass's samples)."""
    from solr_tpu_torch import (CameraMode, PostFxConfig, PostFxMode,
                                RenderConfig)

    w = cell.workload
    extra = dict(cell.settings)
    if "camera_mode" in extra:
        extra["camera_mode"] = CameraMode[extra["camera_mode"]]
    if "postfx" in extra:
        samples = extra.pop("postfx_samples", PostFxConfig.samples)
        extra["postfx"] = PostFxConfig(PostFxMode[extra["postfx"]], samples)
    return RenderConfig(
        width=w["width"], height=w["height"], max_bounces=w["bounces"],
        gradient_background=cell.config["gradient_background"],
        traversal=w["traversal"], **cell.config["packet"], **extra)


def reference_frame(cell, scene, seed):
    """The plain reference's frame (H, W, 3) of ``scene``: the scene
    kind's own ``render(scene, camera, workload, settings, seed)`` where
    ``reference/<kind>.py`` defines one, else ``reference/render.py``'s
    (hard shadows, one sample, no key)."""
    w = cell.workload
    own = getattr(cell.reference_kind, "render", None)
    if own is None:
        rgb = ref.render(scene, cell.config["camera"], w["width"],
                         w["height"], w["bounces"])
    else:
        rgb = own(scene, cell.config["camera"], w, cell.settings, seed)
    return rgb.reshape(w["height"], w["width"], 3)


class _Port:
    """The program: the scene built from the raw inputs by the scene
    kind, its RenderConfig, and its counters."""

    def __init__(self, cell, raw, device):
        t0 = time.perf_counter()
        self.scene, self.cam = cell.scene_kind.build_port(raw, cell.config,
                                                          device)
        sync(device)
        self.build_s = time.perf_counter() - t0
        self.cfg = render_config(cell)

    @staticmethod
    def _counters():
        from solr_tpu_torch.ops import bvh, sweep, traverse

        return {"net": traverse.NET_STATS, "brute": traverse.BRUTE_CALLS,
                "sweep": sweep.LAUNCHES, "walk": bvh.LAUNCHES}

    def counters(self) -> dict:
        return {k: dict(v) for k, v in self._counters().items()}

    def reset_counters(self):
        for c in self._counters().values():
            c.update(dict.fromkeys(c, 0))

    def close(self):
        self.scene = self.cam = None


class PortFrames(_Port):
    """One sample of ``render_sample`` a frame; a cell with render
    settings, samples or a key renders through ``render``, keyed by
    ``Key.seed(seed)``: the same key every frame, so every frame of the
    window is the same image."""

    def __init__(self, cell, raw, device, seed):
        super().__init__(cell, raw, device)
        self.spp, self.key = cell.spp, None
        if cell.keyed:
            from solr_tpu_torch import Key

            self.key = Key.seed(seed, device)
        self.plain = not cell.settings and self.spp == 1 and not cell.keyed

    def frame(self):
        from solr_tpu_torch import render, render_sample

        with torch.no_grad():
            if self.plain:
                return render_sample(self.scene, self.cam, self.cfg)[0]
            return render(self.scene, self.cam, self.cfg, self.key, self.spp)


class PortGrad(_Port):
    """with_params -> render_sample -> MSE against the target ->
    backward over the leaves, then plain gradient descent."""

    def __init__(self, cell, raw, device, target):
        super().__init__(cell, raw, device)
        self.lr = cell.workload["lr"]
        self.target = target
        p = self.scene.params
        v0, v1, v2 = p["vertices"]
        src = {"v0": v0, "v1": v1, "v2": v2,
               "sphere_center": p["sphere_center"],
               "sphere_radius": p["sphere_radius"], "albedo": p["albedo"],
               "light_position": p["light_position"]}
        self.leaves = {k: v.detach().clone().requires_grad_()
                       for k, v in src.items()}
        self.ior = p["ior"]
        self.kept = None

    def step(self) -> float:
        from solr_tpu_torch import render_sample

        L = self.leaves
        scene = self.scene.with_params({
            "sphere_center": L["sphere_center"],
            "sphere_radius": L["sphere_radius"],
            "vertices": (L["v0"], L["v1"], L["v2"]), "albedo": L["albedo"],
            "ior": self.ior, "light_position": L["light_position"]})
        img, _ = render_sample(scene, self.cam, self.cfg)
        loss = ((img[..., :3] - self.target) ** 2).mean()
        loss.backward()
        _descend(self)
        return float(loss.detach())


class _Reference:
    """The plain reference in the program's place, in ``dtype``; ``seed``
    as the program's frames get it."""

    build_s = 0.0

    def __init__(self, cell, raw, device, dtype, seed=None):
        self.scene = cell.reference_kind.reference_scene(
            raw, cell.config, device, dtype)
        self.cell, self.seed = cell, seed

    def counters(self) -> dict:
        return {}

    def reset_counters(self):
        pass

    def close(self):
        self.scene = None

    def render(self):
        return reference_frame(self.cell, self.scene, self.seed)


class RefFrames(_Reference):
    def frame(self):
        with torch.no_grad():
            return self.render()


class RefGrad(_Reference):
    def __init__(self, cell, raw, device, dtype, target):
        super().__init__(cell, raw, device, dtype)
        self.lr = cell.workload["lr"]
        self.target = target.to(dtype)
        self.kept = None
        self.leaves = {}
        for name, field in LEAVES.items():
            t = getattr(self.scene, field).detach().clone().requires_grad_()
            setattr(self.scene, field, t)
            self.leaves[name] = t

    def step(self) -> float:
        loss = ((self.render() - self.target) ** 2).mean()
        loss.backward()
        _descend(self)
        return float(loss.detach())
