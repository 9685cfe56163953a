"""Share of the traced solves' `lm.normal_equations` spans in which no
kernel ran on the card: 100 × (1 − the union of the trace's kernel
intervals inside the spans / the spans' time), on the profiler's clock."""

from benchmark import spans


def read(ctx):
    return spans.idle_pct(ctx, "lm.solve", "lm.normal_equations")
