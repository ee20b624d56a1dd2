"""Host-side runners of the port: sequence runners, dataset parsing and
calibration, trajectories, metrics, checkpoints, live streams, the
visualisations, the dataset recorder and the scalar NumPy oracle (the native
decoder is ``dvo_tpu_torch.native``)."""
