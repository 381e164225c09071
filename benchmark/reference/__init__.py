"""The plain reference the benchmark holds the program to.

Plain PyTorch and NumPy, float32, computed in blocks; it imports neither
JAX nor the JAX package nor anything of the PyTorch port. It is a frozen
copy of the published CONE mathematics (the model, the coarse window
scores, the window combine, the rounding, fusion, dedup and NMS of the
host post-processing, the criterion with its Hungarian matcher, AdamW and
the corpus search merge), taking as inputs only what the benchmark makes:
the seeded state dict and the raw features. Whatever the program derives
from them (normalised features, adapted features, batches) is worked out
again here.
"""
