"""Host-side runners of the port: sequence runners, dataset parsing and
calibration, trajectories, metrics, checkpoints, live streams and the
visualisations (the native decoder is ``dvo_tpu_torch.native``)."""
