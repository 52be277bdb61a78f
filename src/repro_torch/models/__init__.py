"""LM model zoo of the port: the dense transformer (``transformer.py``),
its building blocks (``layers.py``) and the step factories the serving
engine calls (``api.py``)."""
