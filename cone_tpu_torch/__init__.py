"""cone_tpu_torch — the PyTorch/CUDA port of cone_tpu for NVIDIA Hopper.

CONE-family coarse-to-fine inference over long videos: given a query and a
video as pre-extracted clip features, return ranked [start_sec, end_sec,
score] moments. The modules mirror cone_tpu's names (config, data/, ops/,
models/, eval/pipeline.py) and use PyTorch's idiom inside; parameter names
are the reference's torch state-dict names (convert.py carries weights
across). The coarse stage's kernel is hand-written CUDA for sm_90a
(csrc/, built at first use by kernels/build.py).

Entry points run on "cuda" by default and on the CPU only when the caller
passes device="cpu". This package imports neither jax nor cone_tpu.
"""

__version__ = "0.1.0"
