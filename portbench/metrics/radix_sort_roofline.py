"""radix_sort_roofline (%): the CUDA radix sort (`engine/csrc/
radix_sort.cu`, entered through `engine/psort.py` sort_i32_cuda) against
its byte roofline: every word read once, every output word (and the
permutation) written once, a frozen copy of chip_smoke.py
`time_sorts`' bound."""
import re

from portbench.roofline import share

ENTRY = ("rayforce_tpu_torch.engine.psort", "sort_i32_cuda")
KERNELS = re.compile(
    r"^(void )?(hist|plan|pass|identity|gather|small)_kernel\b")


def call_bytes(words, n_keys=1, skipped=None, perm=False, route=-1):
    rows = int(words[0].shape[0])
    out_words = len(words) + (1 if perm else 0)
    return (len(words) + out_words) * rows * 4


def read(ctx):
    return share(ctx, "radix_sort_roofline", KERNELS)
