"""One runner per kind of work a configuration runs; a configuration's file
names its runner, whose `run(cell)` returns a `harness.RunResult`."""
