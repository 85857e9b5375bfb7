"""The benchmark's plain float64 reference: a frozen copy of the synthetic
head model, the grid and the table decomposition, and the golden render
maps vectorised in torch (`fast.py`), which the runs use. Nothing here
imports the program under test."""
