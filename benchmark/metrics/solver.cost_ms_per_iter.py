"""Host milliseconds per LM iteration of the traced solves in the
retraction, the robust cost and the accept / λ blend (`lm.cost`)."""

from benchmark import spans


def read(ctx):
    return spans.ms_per_iter(ctx, "lm.cost")
