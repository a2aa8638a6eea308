"""Share of the traced window in which no operation runs on the device: one
less the union of the device operations' intervals over the window, in
percent. Moves train_graphs_per_s."""

from perfbench.core.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, 'train')
