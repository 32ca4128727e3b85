"""The few CUDA calls the drivers make, as no-ops on the CPU, where the
benchmark's own tests drive them at tiny sizes."""

from __future__ import annotations

import torch


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if _on_card(device):
        torch.cuda.reset_peak_memory_stats(device)


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if _on_card(device) else 0


def empty_cache(device) -> None:
    if _on_card(device):
        torch.cuda.empty_cache()
