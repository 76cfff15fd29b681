"""Device selection and numerics switches (the role ``core/xla_env.py``
plays for ``repro``).

The port runs on the card by default.  ``cpu`` is used only when a caller
asks for it (the parity tests do); a missing card is an error, never a
silent fallback.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a model or engine runs on; ``None`` means ``cuda``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is visible.  Also turns TF32 off for matmuls and
    cuDNN: the f32 logits head (``repro/models/layers.py:260-268``) and
    the f32 parity paths must not drop to TF32's ~10-bit mantissa.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "visible; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                         "('meta' builds shapes only, for the dry run)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
