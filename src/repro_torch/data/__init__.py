"""Datasets: the seeded synthetic JSC loader and the synthetic LM token
stream."""
