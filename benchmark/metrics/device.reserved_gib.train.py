"""The card memory the process holds at its peak over the window and the
traced steps (``torch.cuda.max_memory_reserved`` after the window's
``reset_peak_memory_stats``), in GiB: the caching allocator's blocks,
those of a CUDA graph's private pool included, which
``device.peak_gib.train`` (``max_memory_allocated``) leaves out once the
capture's tensors are gone. None without a card."""


def read(r):
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_reserved() / 2**30
