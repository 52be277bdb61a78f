"""Fused DWN kernels: encode -> LUT layer(s) -> popcount -> first argmax in
one launch (``kernel.py``), on the float datapath (``fused_dwn``) or on
packed words, their plain versions (``ref.py``) and their entry points
(``ops.py``: the float ``forward`` and the packed serving path)."""
