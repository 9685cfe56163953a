"""Host milliseconds per LM iteration of the traced solves in the
linearization and normal equations (`lm.normal_equations`)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_iter(ctx, "lm.normal_equations")
