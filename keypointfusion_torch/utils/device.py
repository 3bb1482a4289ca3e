"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU by
name. With no card and no explicit request they raise: nothing continues
on the CPU without being asked to. Constants the forward reads on every
call are kept per device (`device_constant`).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> the current CUDA device (raises without one); anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run '
                'on the CPU')
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(device)


_CONSTANTS: dict = {}


def device_constant(key, device,
                    build: Callable[[torch.device], torch.Tensor]
                    ) -> torch.Tensor:
    """build(device)'s tensor, made on `device` once per (key, device)
    and kept for the life of the process, so later calls enqueue no
    host-to-device copy and the host does not wait on the card.
    A CUDA device without an index is the current one. The tensor is made
    outside inference mode, so autograd may save it for a backward even
    when the first call came under `torch.inference_mode()`. Callers only
    read it. Two threads that miss together each build the same value;
    the first stored is kept."""
    device = torch.device('cpu' if device is None else device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    entry = (key, device)
    value = _CONSTANTS.get(entry)
    if value is None:
        with torch.inference_mode(False):
            value = _CONSTANTS.setdefault(entry, build(device))
    return value
