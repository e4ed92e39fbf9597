"""sort_key_words_per_query (words): key words sorted by the CUDA radix
sort (`engine/csrc/radix_sort.cu` via `engine/psort.py` sort_i32_cuda;
LAUNCHES["radix_key_words"], each call's `n_keys`: an i32 key one word,
an i64 or f64 key two) in the window, per completed query. Each key word
is four 8-bit passes over the sort's rows, less those the kernel skips.
A program without the counter counts nothing, and the metric is left
out."""


def read(ctx):
    if "radix_key_words" not in ctx.launches:
        return None
    return ctx.launches["radix_key_words"] / len(ctx.queries)
