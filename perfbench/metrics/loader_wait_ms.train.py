"""Host milliseconds a training step waits in next() on the port's
BucketedLoader (a harness span around the call), the mean over the traced
steps. Moves train_graphs_per_s."""

from perfbench.core.readers import mean_ms


def read(ctx):
    return mean_ms(ctx.loader_wait_s, 1e3) if ctx.kind == 'train' else None
