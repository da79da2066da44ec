"""Systems that stand in for the program to show that the check fails
them: the control (the plain reference one precision below the
configuration's float32, bfloat16) and the faults a cell can have.  The
benchmark's own runs use none of them; ``python -m solbench.readings``
and the tests do."""

from __future__ import annotations

import torch

from solbench import systems


def control_frames(cell, raw, device, seed):
    return systems.RefFrames(cell, raw, device, torch.bfloat16, seed)


def control_grad(cell, raw, device, target):
    return systems.RefGrad(cell, raw, device, torch.bfloat16, target)


class AlteredTile(systems.PortFrames):
    """A 32 x 32 block of every frame altered where it is produced."""

    def frame(self):
        img = super().frame().clone()
        img[:32, :32, :3] += 0.25
        return img


class HalfFrame(systems.PortFrames):
    """Half of the frame's rows left out."""

    def frame(self):
        img = super().frame().clone()
        img[img.shape[0] // 2:] = 0.0
        return img


class StateUnchanged(systems.PortGrad):
    """A step that returns its state unchanged."""

    def step(self) -> float:
        lr, self.lr = self.lr, 0.0
        try:
            return super().step()
        finally:
            self.lr = lr


class HalfBatch(systems.PortGrad):
    """Half of the pixels left out, the mean taken over the rest."""

    def __init__(self, cell, raw, device, target):
        super().__init__(cell, raw, device, target)
        self.target = target[: target.shape[0] // 2]

    def step(self) -> float:
        from solr_tpu_torch import render_sample

        L = self.leaves
        scene = self.scene.with_params({
            "sphere_center": L["sphere_center"],
            "sphere_radius": L["sphere_radius"],
            "vertices": (L["v0"], L["v1"], L["v2"]), "albedo": L["albedo"],
            "ior": self.ior, "light_position": L["light_position"]})
        img, _ = render_sample(scene, self.cam, self.cfg)
        half = img[: img.shape[0] // 2, :, :3]
        loss = ((half - self.target) ** 2).mean()
        loss.backward()
        systems._descend(self)
        return float(loss.detach())


class AlteredGradient(systems.PortGrad):
    """The gradient altered where it is produced: every leaf's times
    1.5."""

    def step(self) -> float:
        hooks = [t.register_hook(lambda g: 1.5 * g)
                 for t in self.leaves.values()]
        try:
            return super().step()
        finally:
            for h in hooks:
                h.remove()


FRAME_FAULTS = {"altered_tile": AlteredTile, "half_frame": HalfFrame}
GRAD_FAULTS = {"state_unchanged": StateUnchanged, "half_batch": HalfBatch,
               "altered_gradient": AlteredGradient}
