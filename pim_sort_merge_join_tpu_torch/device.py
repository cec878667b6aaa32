"""Where the port's entry points put their tensors unless told otherwise.

The port runs on the card: `QueryPipeline`, the table constructors, the CSV
loader and `convert.table_from_reference` take ``device=None`` to mean
`DEFAULT_DEVICE`. The CPU, where the kernels' plain torch versions run, is
used only when a caller names it (``device="cpu"``), as the tests do.
Nothing falls back: without a card the default raises.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a `torch.device`, `DEFAULT_DEVICE` for None; raises
    `RuntimeError` for a CUDA device when no card is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        asked = "the default device" if device is None else f"device={str(device)!r}"
        raise RuntimeError(
            f"{asked}: no CUDA device is available (pass device='cpu' to run "
            "the plain torch versions)"
        )
    return dev


def rank_device(device: str | torch.device | None = None) -> str:
    """Where spawned ranks put their tensors, as a string they can pickle:
    ``device`` resolved as above, a card without an index as ``cuda:0``
    (ranks that share one card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return str(dev)
