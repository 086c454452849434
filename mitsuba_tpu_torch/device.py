"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch.device an entry point runs on. A CUDA request with no card
    raises: the port never moves to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev


def check_scene_device(scene, device) -> torch.device:
    """resolve_device(device), which must be the type of device the scene
    was compiled on (a render never moves a scene)."""
    dev = resolve_device(device)
    if scene.device.type != dev.type:
        raise ValueError(f"scene lives on {scene.device}, render asked "
                         f"for {dev}")
    return dev
