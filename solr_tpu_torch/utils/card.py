"""The card a measurement ran on, named as nvidia-smi names it."""

from __future__ import annotations

import subprocess

import torch

__all__ = ["card_name"]


def card_name(device="cuda") -> str:
    """The name and power limit of ``device``'s card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    the device type off the card.  The card is picked by its UUID:
    nvidia-smi numbers cards in PCI order, which neither
    CUDA_VISIBLE_DEVICES nor CUDA's own ordering changes, so a CUDA
    ordinal may name another card there."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = torch.cuda.current_device() if device.index is None else device.index
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    if not uuid.startswith("GPU-"):
        uuid = "GPU-" + uuid
    res = subprocess.run(
        ["nvidia-smi", f"--id={uuid}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()
