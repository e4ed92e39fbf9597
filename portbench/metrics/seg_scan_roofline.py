"""seg_scan_roofline (%): the CUDA segmented scan (`engine/csrc/
seg_scan.cu`, entered through `engine/groupby.py` seg_scan_cuda)
against its byte roofline: ids read once, values read once and written
once, a frozen copy of chip_smoke.py `time_scan`'s bound."""
import re

from portbench.roofline import share

ENTRY = ("rayforce_tpu_torch.engine.groupby", "seg_scan_cuda")
KERNELS = re.compile(r"\bseg_scan::")


def call_bytes(seg_ids, vals, op, reverse=False):
    n = int(vals.shape[0])
    lanes = int(vals[0].numel()) if n else 0
    return n * (seg_ids.element_size() + 2 * vals.element_size() * lanes)


def read(ctx):
    return share(ctx, "seg_scan_roofline", KERNELS)
