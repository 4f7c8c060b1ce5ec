"""Where the port runs: the CUDA device unless the caller asks for the CPU.

Every entry point (``train``, ``predict``, ``RayXGBoostBooster.predict``,
``serve``) resolves its ``device`` argument here: ``None`` is the current
CUDA device and raises when there is none; ``"cpu"`` runs the plain
PyTorch versions of the kernels (what the tests use). There is no silent
fallback from the card to the CPU.
"""

import torch


def resolve_device(device) -> torch.device:
    """``None`` -> the card; the CPU only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "xgboost_ray_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch path "
                "on the CPU."
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
