"""Runtime services: checkpoints on the reference's on-disk layout."""
