"""Datasets: the seeded synthetic JSC loader."""
