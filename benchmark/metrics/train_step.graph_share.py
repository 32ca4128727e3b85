"""The share of the model's layers that the training forwards replayed
from CUDA graphs (tdeed_tpu_torch/models/graphs.py): over the steps in
the program's ring of step records (utils/profiling.py ``STEPS``, the
last 256) that ran with no profiler recording, the layers replayed over
the layers replayed and run eagerly. None where the program keeps no
such count."""


def read(r):
    from tdeed_tpu_torch.utils import profiling

    steps = getattr(profiling, "STEPS", None)
    records = [rec for rec in getattr(steps, "records", ()) if not rec.profiled]
    if not records or not all(hasattr(rec, "graph_layers") for rec in records):
        return None
    graphed = sum(rec.graph_layers for rec in records)
    total = graphed + sum(rec.eager_layers for rec in records)
    return graphed / total if total else None
