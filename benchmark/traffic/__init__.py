"""Traffic generators of the benchmark: ground-truth trajectories, the
simulated measurement stream of the streaming cells and the window problems
of the batched-solve cells. Copies of the port's `utils/synthetic.py` and
`utils/sequence.py`, so that a change to the port cannot move the inputs."""
