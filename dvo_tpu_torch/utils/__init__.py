"""Host-side runners of the port: sequence runners, metrics, checkpoints,
live streams and the keyframe gallery.  Dataset parsing, calibration,
trajectories and the native decoder are ``dvo_tpu``'s own (they import no
jax)."""
