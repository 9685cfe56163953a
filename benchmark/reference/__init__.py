"""The benchmark's plain reference: a frozen copy of the port's float64 path
(`ops/{lie,preintegration,factors,window,marginalization,triangulation}`,
`models/{anticipation,estimator_device}`, `feature_selector._device_select`,
`utils/tree`), importing nothing of the port and taking nothing it made.

Where the copy departs from the port:

- no kernel: `window.lm_solve` always takes the float64 Schur solve
  (`schur_solve`), and the selector's "chol" scoring is the batched
  Cholesky log-determinant of the materialised Ω + p·Δ (`lie.logdet_psd`);
  "lowrank" is not copied;
- `estimator_device.vio_step(..., picks=)` takes the gate's selection from
  outside (`_given_picks`), so that the rest of the step can follow a
  selection it did not make; `candidates` names the selection's candidates;
- the host hand-off `vio_init_from_host` is not copied.

Run in float64 it is the reference; run in float32 with TF32 matrix
products it is the control of the correctness check.
"""
