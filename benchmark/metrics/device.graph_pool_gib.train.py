"""The card memory the CUDA graphs' private pools hold after the window and
the traced steps, in GiB: the bytes of the caching allocator's segments
(``torch.cuda.memory_snapshot()``) whose ``segment_pool_id`` is not the
default pool's (0, 0). In the benchmark's process the only private pools
are those the model's layers capture into (tdeed_tpu_torch/models/graphs.py),
and a replay allocates nothing, so this is what their captures took: the
part of ``device.reserved_gib.train`` the graphs keep between steps, the
rest being the step's eager blocks. Read once, after the measured steps.
None without a card."""

DEFAULT_POOL = (0, 0)


def read(r):
    import torch

    if not torch.cuda.is_available():
        return None
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) != DEFAULT_POOL) / 2**30
