"""mesh_moved_mb_per_query (MB): bytes that the mesh's in-process
collectives copied from one card to another in the traced window
(`rayforce_tpu_torch/parallel/dist.py` moved["bytes"], counted where a
collective moves a tensor between cards), per completed query, in
units of 1e6 bytes. Not the modelled `dist.stats["exchanged_bytes"]`.

The harness loads a per-layer metric's reader after set-up, just before
the window; the counter's reading at that load is the window's base. A
program without the counter reads nothing, and the metric is left
out."""
import importlib


def _counter():
    """The program's counter of moved bytes, or None."""
    try:
        mod = importlib.import_module("rayforce_tpu_torch.parallel.dist")
    except ImportError:
        return None
    return getattr(mod, "moved", None)


MOVED = _counter()
BASE = None if MOVED is None else MOVED["bytes"]


def read(ctx):
    if MOVED is None:
        return None
    return (MOVED["bytes"] - BASE) / 1e6 / len(ctx.queries)
