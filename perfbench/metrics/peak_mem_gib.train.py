"""torch.cuda.max_memory_allocated over the window, after
reset_peak_memory_stats at its start, in GiB. Moves train_graphs_per_s."""

from perfbench.core.readers import peak_mem_gib


def read(ctx):
    return peak_mem_gib(ctx, 'train')
