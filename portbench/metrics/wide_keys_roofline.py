"""wide_keys_roofline (%): the wide engine's key-word kernels
(`engine/csrc/wide_keys.cu`, entered through `engine/wide.py`
wide_keys_cuda: pack, bound, decode) against their byte roofline: every
input read once (a broadcast key or mask one element), every output
written once, a frozen copy of chip_smoke.py `wide_keys_bytes`. A
program without the entry records no call, and the metric is left
out."""
import importlib
import re

from portbench.roofline import share

KERNELS = re.compile(r"\bwide_keys::")


def _entry():
    """The entry (module, attribute) where the program has it, else
    None: the harness records no call."""
    name = "rayforce_tpu_torch.engine.wide"
    try:
        mod = importlib.import_module(name)
    except ImportError:
        return None
    return (name, "wide_keys_cuda") if hasattr(mod, "wide_keys_cuda") \
        else None


ENTRY = _entry()


def _read_bytes(x):
    """An input's bytes: one element where every row reads the same."""
    one = x.dim() == 0 or x.stride(0) == 0
    return x.element_size() * (1 if one else x.numel())


def call_bytes(step, lay, ins, outs):
    return sum(_read_bytes(x) for x in ins) + \
        sum(x.numel() * x.element_size() for x in outs)


def read(ctx):
    return share(ctx, "wide_keys_roofline", KERNELS)
