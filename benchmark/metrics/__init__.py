"""Per-layer metric readers, one file per metric, named as the metric.

Each defines `read(ctx) -> float | None`. `ctx.trace` is the
`trace.Trace` of the traced units (None where nothing was traced),
`ctx.counters` the runner's counts over them, `ctx.config` and
`ctx.traffic` the cell's files. A reader that finds nothing to read
returns None, and the harness leaves the metric out of the result."""
