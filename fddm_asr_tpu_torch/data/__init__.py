"""Host data: audio reading and resampling, manifests and batches, the feature cache."""
